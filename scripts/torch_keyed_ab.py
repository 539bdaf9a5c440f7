#!/usr/bin/env python3
"""Time this checkout's batched B1/B2 wrappers and keyed updates against another checkout's, on one CUDA card.

Run from the root of a checkout, on a machine with one H100, with the other
checkout unpacked somewhere (for example ``git archive <commit> | tar -x -C
build/parent``):

    python3 scripts/torch_keyed_ab.py build/parent

As in ``scripts/torch_scatter_ab.py``, both packages are imported into one
process side by side, each with its own kernel library built from its own
sources, and their calls alternate one by one, the side that goes first
alternating too (the host's speed swings between processes):

1. B2's batched wrapper (``confmat_counts_batched_cuda``) at the keyed
   ``ConfusionMatrix(16)`` rows' stacks (8192, 1, 16) and (256, 1, 16) and at
   a bootstrap's (20, 1024, 1000), int64 labels in [-1, C]; and B1's batched
   wrapper at the keyed P/R/F1 rows' (4096, 1, 10) stack. Outputs checked
   equal, then 400 pairs of calls timed by CUDA events (the wrapper time of
   ``chip_smoke.py``), and each side's device time by the profiler (turns
   this, other, other, this; the mean of its two).
2. Phase 3b's keyed update of ``chip_smoke.py`` (``MultiTenantCollection``
   of Accuracy and macro Precision/Recall/F1, 10,000 tenants, 50 updates of
   4096 rows), three rounds, each update timed on the host clock up to
   ``torch.cuda.synchronize()``; the B1 launches of each side are printed.
3. Phase 3o-a's keyed update: ``KeyedMetric(ConfusionMatrix(16))`` over
   4,096 tenants, 50 seeded updates of 256 rows and 10 of 8,192, three
   rounds, timed as in 2; the B2 launches of each side are printed.

The stacked states of 2 and 3 must end equal between the checkouts. It
prints medians, the ratio this/other, and in how many pairs this checkout
was faster.
"""
import os
import sys
import time

import numpy as np

from torch_scatter_ab import PAIRS, ROOT, load, summary

ROUNDS = 3
NAMES = ("", ".kernels._common", ".kernels.confusion_matrix", ".kernels.stat_scores")


def alternate(calls, rounds_of, sync) -> tuple:
    """Host time (ms) of each call of ``rounds_of`` on both sides, in turns,
    each timed up to ``sync()``."""
    times = ([], [])
    for k, args in enumerate(rounds_of):
        for side in ((0, 1) if k % 2 == 0 else (1, 0)):
            sync()
            t0 = time.perf_counter()
            calls[side](*args)
            sync()
            times[side].append((time.perf_counter() - t0) * 1e3)
    return times


def states_equal(torch, a, b) -> bool:
    return all(torch.equal(v, getattr(b, n)) for n, v in a._get_states().items())


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.splitlines()[0], file=sys.stderr)
        print(f"usage: {sys.argv[0]} OTHER_CHECKOUT", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available; this script runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as c

    this, other = load(ROOT, NAMES), load(os.path.abspath(sys.argv[1]), NAMES)
    sides = (this, other)
    print(c.card_line())
    for side, mods in (("this", this), ("other", other)):
        path, _ = mods[".kernels._common"].build_library()
        print(f"[ab] {side}: {mods[''].__file__}, library {path.name}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(c.SEED + 15)

    cases = []
    for b, n, k in ((2 * c.CKPT_TENANTS, 1, c.CKPT_CLASSES), (c.CKPT_FLIGHT_ROWS, 1, c.CKPT_CLASSES),
                    (c.BOOTSTRAPS, c.BATCH, c.NUM_CLASSES)):
        p, t = (torch.randint(-1, k + 1, (b, n), generator=gen, device=dev) for _ in range(2))
        fns = [m[".kernels.confusion_matrix"].confmat_counts_batched_cuda for m in sides]
        cases.append((f"B2 batched ({b}, {n}, {k})",
                      [lambda fn=fn, p=p, t=t, k=k: fn(p, t, k, device=dev) for fn in fns]))
    p, t = (torch.randint(0, 2, (c.KEYED_ROWS, 1, c.KEYED_CLASSES), generator=gen, device=dev, dtype=torch.int32)
            for _ in range(2))
    fns = [m[".kernels.stat_scores"].stat_scores_counts_cuda for m in sides]
    cases.append((f"B1 batched ({c.KEYED_ROWS}, 1, {c.KEYED_CLASSES})",
                  [lambda fn=fn: fn(p, t, device=dev) for fn in fns]))
    for name, calls in cases:
        got = [call() for call in calls]
        same = [torch.equal(a, b) for a, b in zip(*got)] if isinstance(got[0], tuple) else [torch.equal(*got)]
        if not all(same):
            print(f"[ab] {name}: the two checkouts' outputs DIFFER", file=sys.stderr)
            return 1
        for call in calls * 10:
            call()
        torch.cuda.synchronize()
        times = ([], [])
        for rep in range(PAIRS):
            for side in ((0, 1) if rep % 2 == 0 else (1, 0)):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                calls[side]()
                end.record()
                end.synchronize()
                times[side].append(start.elapsed_time(end))
        summary(f"{name} wrapper", times[0], times[1], "ms")
        device = ([], [])
        for side in (0, 1, 1, 0):
            device[side].append(c.device_ms(calls[side]))
        means = [None if None in d else sum(d) / len(d) for d in device]
        print(f"[ab] {name} device: this {means[0]} ms, other {means[1]} ms (profiler, two turns each)")

    def sync():
        torch.cuda.synchronize()

    def launches(op):
        return [m[".kernels._common"].launch_count(op) for m in sides]

    batches = c.make_keyed_batches(torch, dev)
    keyed = [c.build_keyed(m[""], dev) for m in sides]
    for m in sides:
        m[".kernels._common"].reset_dispatch_counters()
    times = alternate([k.update for k in keyed], batches * ROUNDS, sync)
    summary(f"phase 3b keyed update ({len(batches)} updates x {ROUNDS} rounds)", times[0], times[1], "ms")
    print(f"[ab] phase 3b B1 launches (this, other): {launches('stat_scores_counts')}")
    if not all(states_equal(torch, km, keyed[1]._keyed[o]) for o, km in keyed[0]._keyed.items()):
        print("[ab] phase 3b keyed states differ between the checkouts", file=sys.stderr)
        return 1

    rng = np.random.RandomState(0)
    n, nc = c.CKPT_TENANTS, c.CKPT_CLASSES
    for rows, count in ((c.CKPT_FLIGHT_ROWS, 50), (2 * n, 10)):
        cohorts = [tuple(torch.as_tensor(a, device=dev) for a in c._ckpt_batch(np, rng, rng.randint(0, n, rows), nc))
                   for _ in range(count)]
        metrics = [m[""].KeyedMetric(m[""].ConfusionMatrix(num_classes=nc, device=dev), num_tenants=n,
                                     validate_ids=False, device=dev) for m in sides]
        for m in sides:
            m[".kernels._common"].reset_dispatch_counters()
        times = alternate([m.update for m in metrics], cohorts * ROUNDS, sync)
        summary(f"phase 3o-a keyed ConfusionMatrix({nc}) update of {rows} rows ({count} x {ROUNDS})", times[0],
                times[1], "ms")
        print(f"[ab] phase 3o-a B2 launches (this, other): {launches('confmat_counts')}")
        if not torch.equal(metrics[0].confmat, metrics[1].confmat):
            print("[ab] phase 3o-a keyed states differ between the checkouts", file=sys.stderr)
            return 1
    print("[ab] keyed states equal between the checkouts")
    return 0


if __name__ == "__main__":
    sys.exit(main())
