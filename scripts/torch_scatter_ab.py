#!/usr/bin/env python3
"""Time this checkout's segment-scatter wrappers (B3, B4) and keyed update against another checkout's, on one CUDA card.

Run from the root of a checkout, on a machine with one H100, with the other
checkout unpacked somewhere (for example ``git archive <commit> | tar -x -C
build/parent``):

    python3 scripts/torch_scatter_ab.py build/parent

The host's speed swings by 2x between processes on one machine, so two
versions timed in two processes compare the processes as much as the code.
Here both packages (``metrics_tpu_torch`` of this checkout and of the other)
are imported into one process side by side, each with its own kernel
library built from its own sources, and their calls alternate one by one,
the side that goes first alternating too:

1. B3 (rows (4096, 40) and (4096, 6)) and B4 max/min (rows (4096, 1)) at
   the keyed path's shapes, 10,000 segments, int64 ids: both outputs
   checked equal, then 400 pairs of calls, each call timed by CUDA events
   (the wrapper time of ``chip_smoke.py``), and 20 pairs of blocks of 100
   calls back to back on the host clock (host time per call).
2. The keyed path of ``chip_smoke.py`` (``MultiTenantCollection`` of
   Accuracy and macro Precision/Recall/F1, 10,000 tenants, 50 updates of
   4096 rows), three rounds: each batch goes to both collections, one after
   the other, each update timed on the host clock up to
   ``torch.cuda.synchronize()``. The stacked states must end equal.

It prints medians, the ratio this/other, and in how many pairs this
checkout was faster.
"""
import importlib
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "metrics_tpu_torch"
PAIRS = 400
BLOCKS, BLOCK = 20, 100
ROUNDS = 3


def load(checkout: str, names=("", ".kernels._common", ".kernels.segment_scatter")) -> dict:
    """Import ``checkout``'s package (the modules ``names``, relative to it)
    apart from any other copy: its modules leave ``sys.modules`` once loaded
    (the package imports nothing lazily), so another checkout's copy can load
    beside it."""
    ours = [n for n in sys.modules if n == PKG or n.startswith(PKG + ".")]
    saved = {n: sys.modules.pop(n) for n in ours}
    sys.path.insert(0, checkout)
    try:
        return {n: importlib.import_module(f"{PKG}{n}") for n in names}
    finally:
        sys.path.remove(checkout)
        for n in [n for n in sys.modules if n == PKG or n.startswith(PKG + ".")]:
            del sys.modules[n]
        sys.modules.update(saved)


def summary(name: str, this: list, other: list, unit: str) -> None:
    wins = sum(t < o for t, o in zip(this, other))
    mt, mo = statistics.median(this), statistics.median(other)
    print(f"[ab] {name}: this {mt:.4f} {unit}, other {mo:.4f} {unit} (medians of {len(this)}), this/other "
          f"{mt / mo:.3f}; this faster in {wins} of {len(this)} pairs")


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

    other_dir = os.path.abspath(sys.argv[1])
    this, other = load(ROOT), load(other_dir)
    print(c.card_line())
    for side, mods in (("this", this), ("other", other)):
        path, _ = mods[".kernels._common"].build_library()
        print(f"[ab] {side}: {mods[''].__file__}, library {path.name}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(c.SEED + 11)
    s = c.KEYED_TENANTS
    ids = torch.randint(0, s, (c.KEYED_ROWS,), generator=gen, device=dev)
    for op, d in (("add", 40), ("add", 6), ("max", 1), ("min", 1)):
        rows = torch.randint(0, 2, (c.KEYED_ROWS, d), generator=gen, device=dev).float()
        fns = [getattr(m[".kernels.segment_scatter"], f"segment_scatter_{op}_cuda") for m in (this, other)]
        calls = [lambda fn=fn: fn(rows, ids, s, device=dev) for fn in fns]
        got = [call() for call in calls]
        if not all(torch.equal(a, b) for a, b in zip(*got)):
            print(f"[ab] segment_scatter_{op} D={d}: the two checkouts' outputs DIFFER", file=sys.stderr)
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
        summary(f"segment_scatter_{op} D={d} wrapper", times[0], times[1], "ms")
        host = ([], [])
        for rep in range(BLOCKS):
            for side in ((0, 1) if rep % 2 == 0 else (1, 0)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(BLOCK):
                    calls[side]()
                host[side].append((time.perf_counter() - t0) / BLOCK * 1e6)
        torch.cuda.synchronize()
        summary(f"segment_scatter_{op} D={d} host per call", host[0], host[1], "us")

    batches = c.make_keyed_batches(torch, dev)
    keyed = [c.build_keyed(m[""], dev) for m in (this, other)]
    updates = ([], [])
    for rnd in range(ROUNDS):
        for i, batch in enumerate(batches):
            for side in ((0, 1) if (rnd * len(batches) + i) % 2 == 0 else (1, 0)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                keyed[side].update(*batch)
                torch.cuda.synchronize()
                updates[side].append((time.perf_counter() - t0) * 1e3)
    summary("keyed update (50 updates x 3 rounds)", updates[0], updates[1], "ms")
    for owner, km in keyed[0]._keyed.items():
        for name, value in km._get_states().items():
            if not torch.equal(value, getattr(keyed[1]._keyed[owner], name)):
                print(f"[ab] keyed state {owner}.{name} differs between the checkouts", file=sys.stderr)
                return 1
    print("[ab] keyed states equal between the checkouts")
    return 0


if __name__ == "__main__":
    sys.exit(main())
