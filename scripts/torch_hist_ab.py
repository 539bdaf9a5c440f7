#!/usr/bin/env python3
"""Time this checkout's label/score histogram wrapper (B5) and sketched curve updates against another checkout's, on one CUDA card.

Run from the root of a checkout, on a machine with one H100, with the other
checkout unpacked somewhere (for example ``git archive <commit> | tar -x -C
build/parent``):

    python3 scripts/torch_hist_ab.py build/parent

As ``scripts/torch_scatter_ab.py`` does for the segment scatters, both
packages are imported into one process side by side, each with its own
kernel library built from its own sources, and their calls alternate one by
one, the side that goes first alternating too (the host's speed swings by
2x between processes on one machine):

1. B5 at the curve path's shape (``(1024, 1000)`` softmax scores, one-hot
   int32 targets, 2048 bins) and at the binary stream's (``(10000, 1)``):
   both outputs checked equal, then 400 pairs of calls, each timed by CUDA
   events (the wrapper time of ``chip_smoke.py``), 20 pairs of blocks of 100
   calls back to back on the host clock (host time per call), and each
   side's device time per call split by the name of the device operation
   (fill, memset, kernel), by the profiler.
2. The sketched curve path of ``chip_smoke.py`` (1000-class ``AUROC`` +
   ``AveragePrecision``, 49 batches) and its binary stream (``AUROC`` +
   ``ROC`` + ``PrecisionRecallCurve``, 100 chunks of 10,000 scores), three
   rounds each: every batch goes to both sides, one after the other, each
   update timed on the host clock up to ``torch.cuda.synchronize()``. The
   histogram states must end equal. Then the device time of ten curve
   updates and of ten stream updates on each side, by the profiler, split
   by operation.

It prints medians, the ratio this/other, and in how many pairs this
checkout was faster.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = 400
BLOCKS, BLOCK = 20, 100
ROUNDS = 3
MODULES = ("", ".kernels._common", ".kernels.binned_counts")
HIST_STATES = ("pos_hist", "neg_hist", "sketch_clipped")


def print_split(label: str, split: dict) -> None:
    print(f"[ab] {label}: device {sum(split.values()):.3f} us per call")
    for name, us in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"[ab]   {us:8.3f} us  {name}")


def interleave(torch, calls, pairs: int = PAIRS):
    """CUDA-event time (ms) of each call of the two ``calls``, in turns."""
    times = ([], [])
    for rep in range(pairs):
        for side in ((0, 1) if rep % 2 == 0 else (1, 0)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            calls[side]()
            end.record()
            end.synchronize()
            times[side].append(start.elapsed_time(end))
    return times


def host_blocks(torch, calls):
    """Host time (us per call) of blocks of calls back to back, in turns."""
    host = ([], [])
    for rep in range(BLOCKS):
        for side in ((0, 1) if rep % 2 == 0 else (1, 0)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BLOCK):
                calls[side]()
            host[side].append((time.perf_counter() - t0) / BLOCK * 1e6)
    torch.cuda.synchronize()
    return host


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
    from torch_scatter_ab import load, summary

    this, other = load(ROOT, MODULES), load(os.path.abspath(sys.argv[1]), MODULES)
    sides = (("this", this), ("other", other))
    print(c.card_line())
    for side, mods in sides:
        path, _ = mods[".kernels._common"].build_library()
        print(f"[ab] {side}: {mods[''].__file__}, library {path.name}")
    dev = torch.device("cuda", 0)
    batches = c.make_batches(torch, dev)
    chunks = c.make_stream(torch, dev)
    onehot = (batches[0][1].unsqueeze(1) == torch.arange(c.NUM_CLASSES, device=dev)).to(torch.int32)
    shapes = (("C=1000", batches[0][0], onehot),
              ("C=1", chunks[0][0].reshape(-1, 1), chunks[0][1].reshape(-1, 1).to(torch.int32)))
    for label, scores, labels in shapes:
        fns = [m[".kernels.binned_counts"].label_score_histograms_cuda for m in (this, other)]
        calls = [lambda fn=fn: fn(scores, labels, c.NUM_BINS, device=dev) for fn in fns]
        got = [call() for call in calls]
        if not all(torch.equal(a, b) for a, b in zip(*got)):
            print(f"[ab] label_score_histograms {label}: the two checkouts' outputs DIFFER", file=sys.stderr)
            return 1
        for call in calls * 10:
            call()
        torch.cuda.synchronize()
        times = interleave(torch, calls)
        summary(f"label_score_histograms {label} wrapper", times[0], times[1], "ms")
        host = host_blocks(torch, calls)
        summary(f"label_score_histograms {label} host per call", host[0], host[1], "us")
        for (side, _), call in zip(sides, calls):
            print_split(f"label_score_histograms {label}, {side}", c.device_split(call))

    curves = [c.build_curves(m[""], dev) for m in (this, other)]
    updates = ([], [])
    for rnd in range(ROUNDS):
        for i, batch in enumerate(batches):
            for side in ((0, 1) if (rnd * len(batches) + i) % 2 == 0 else (1, 0)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                curves[side].update(*batch)
                torch.cuda.synchronize()
                updates[side].append((time.perf_counter() - t0) * 1e3)
    summary(f"curve update (49 batches x {ROUNDS} rounds)", updates[0], updates[1], "ms")
    for name in ("AUROC", "AveragePrecision"):
        for state in HIST_STATES:
            if not torch.equal(getattr(curves[0][name], state), getattr(curves[1][name], state)):
                print(f"[ab] curve state {name}.{state} differs between the checkouts", file=sys.stderr)
                return 1
    print("[ab] curve states equal between the checkouts")

    streams = [c.build_stream(m[""], dev) for m in (this, other)]
    updates = ([], [])
    for rnd in range(ROUNDS):
        for i, chunk in enumerate(chunks):
            for side in ((0, 1) if (rnd * len(chunks) + i) % 2 == 0 else (1, 0)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for metric in streams[side].values():
                    metric.update(*chunk)
                torch.cuda.synchronize()
                updates[side].append((time.perf_counter() - t0) * 1e3)
    summary(f"stream update, three metrics (100 chunks x {ROUNDS} rounds)", updates[0], updates[1], "ms")
    for name, metric in streams[0].items():
        for state in HIST_STATES:
            if not torch.equal(getattr(metric, state), getattr(streams[1][name], state)):
                print(f"[ab] stream state {name}.{state} differs between the checkouts", file=sys.stderr)
                return 1
    print("[ab] stream states equal between the checkouts")

    for (side, _), collection, stream in zip(sides, curves, streams):
        it = iter(batches[1:11] * 6)
        print_split(f"one curve update (two metrics), {side}",
                    c.device_split(lambda: collection.update(*next(it))))
        it = iter(chunks[1:11] * 6)

        def stream_update(it=it, stream=stream):
            chunk = next(it)
            for metric in stream.values():
                metric.update(*chunk)

        print_split(f"one stream update (three metrics), {side}", c.device_split(stream_update))
    return 0


if __name__ == "__main__":
    sys.exit(main())
