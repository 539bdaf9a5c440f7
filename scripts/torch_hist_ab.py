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

With ``--rule-forms`` in place of another checkout, it compares two forms
of the kernels' vmap rule inside this checkout, call by call in one
process: "this" is the checkout's own rule (``kernels/_common.py::
vmap_stack``, which takes the tensors out of the vmap level and batches the
outputs again itself), "other" the same rule as a ``torch.autograd.Function``
with a ``vmap`` staticmethod (the form B1's and B2's rules had before),
patched into the kernel modules for its turns. Timed on the host clock up
to ``torch.cuda.synchronize()``, each side 150 times in turns:

    python3 scripts/torch_hist_ab.py --rule-forms

1. the rule alone: ``label_score_histograms`` under ``torch.func.vmap`` of
   the keyed binary rows' (4096, 1, 1) stack (one B5 launch a call);
2. the keyed binary sketched curve's update (``chip_smoke.py`` phase 3p-a:
   ``KeyedMetric(AUROC(sketched=True))`` over 10,000 tenants, 4096 rows);
3. phase 3b's keyed update (``MultiTenantCollection`` of Accuracy and macro
   P/R/F1: B1's rule);
4. the keyed ``ConfusionMatrix(16)`` update of phase 3o-a (4,096 tenants,
   256 rows: B2's rule).

Each side's launches per call are counted (they must be equal) and its
states must end equal to the other's.

With ``--profiler-check``, it asks what the profiler's device time of B5's
batched entry measures, at the three stacks of ``chip_smoke.py`` phase 3p
(the keyed binary rows' (4096, 1, 1), the keyed 10-class rows' (4096, 1,
10) with class ids, a bootstrap's (20, 1024, 1000)), and, as controls, at
``Tensor.zero_`` and ``Tensor.copy_`` of as many output bytes:

    python3 scripts/torch_hist_ab.py --profiler-check

For each it prints the byte bound and: the kernel records of the profiler's
trace over 50 calls back to back (how many, and their mean span), the same
with a synchronisation after each call, CUDA events around one call at a
time, CUDA events around 50 calls back to back, and 50 calls in one
replayed CUDA graph. The traces go to ``build/profiler_check/``.
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


def function_rule(torch, batch_first):
    """The kernels' vmap rule as a ``torch.autograd.Function`` with a
    ``vmap`` staticmethod: the same stacks and outputs as
    ``_common.vmap_stack``, through functorch's dispatch of the Function.
    It serves one vmap level, as the keyed updates timed here run; nested
    levels are ``vmap_stack``'s alone."""

    class _Rule(torch.autograd.Function):
        @staticmethod
        def forward(fn, count, *operands):
            return fn(*operands)

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass  # counts: nothing to differentiate

        @staticmethod
        def vmap(info, in_dims, fn, count, *operands):
            tensors = [batch_first(x, d, info.batch_size) for x, d in zip(operands[:count], in_dims[2:2 + count])]
            out = fn(*tensors, *operands[count:])
            if isinstance(out, torch.Tensor):
                return out, 0
            return tuple(out), (0,) * len(out)

    def vmap_stack(fn, tensors, *args):
        return _Rule.apply(fn, len(tensors), *tensors, *args)

    return vmap_stack


def rule_forms() -> int:
    """``--rule-forms``: this checkout's vmap rule against the same rule as
    a ``torch.autograd.Function`` (see the module docstring)."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available; this script runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as c
    import metrics_tpu_torch as M
    from metrics_tpu_torch.kernels import _common, binned_counts, confusion_matrix, stat_scores
    from torch_scatter_ab import summary

    print(c.card_line())
    _common.build_library()
    dev = torch.device("cuda", 0)
    modules = (binned_counts, stat_scores, confusion_matrix)
    rules = (_common.vmap_stack, function_rule(torch, _common.batch_first))

    def use(side):
        for mod in modules:
            mod.vmap_stack = rules[side]

    keyed_batches = c.make_keyed_batches(torch, dev)
    cohorts = c.keyed_binary_cohorts(torch, keyed_batches, dev)
    gen = torch.Generator(device=dev).manual_seed(c.SEED + 20)
    ckpt = []
    for _ in range(c.KEYED_UPDATES):
        logits = torch.rand((c.CKPT_FLIGHT_ROWS, c.CKPT_CLASSES), generator=gen, device=dev)
        ckpt.append((torch.randint(0, c.CKPT_TENANTS, (c.CKPT_FLIGHT_ROWS,), generator=gen, device=dev),
                     logits / logits.sum(1, keepdim=True),
                     torch.randint(0, c.CKPT_CLASSES, (c.CKPT_FLIGHT_ROWS,), generator=gen, device=dev)))
    _, scores, labels = cohorts[0]
    rows = scores.reshape(-1, 1, 1), (labels == 1).to(torch.int32).reshape(-1, 1, 1)
    rule_alone = torch.func.vmap(lambda s, t: binned_counts.label_score_histograms(s, t, c.NUM_BINS))

    def confmat(device):
        return M.KeyedMetric(M.ConfusionMatrix(num_classes=c.CKPT_CLASSES, device=device), c.CKPT_TENANTS,
                             validate_ids=False, device=device)

    cases = [
        ("B5 rule alone, (4096, 1, 1) under vmap", None, lambda m, x: rule_alone(*x), [rows] * c.KEYED_UPDATES),
        ("keyed binary sketched AUROC update (3p-a)", lambda: c.build_sketched_keyed(M, dev),
         lambda m, x: m.update(*x), cohorts),
        ("keyed collection update (3b, B1's rule)", lambda: c.build_keyed(M, dev), lambda m, x: m.update(*x),
         keyed_batches),
        ("keyed ConfusionMatrix(16) update of 256 rows (3o-a, B2's rule)", lambda: confmat(dev),
         lambda m, x: m.update(*x), ckpt),
    ]
    for label, build, step, inputs in cases:
        objs = [build() if build else None for _ in range(2)]
        for side in (0, 1):  # warm-up, not timed: each side's first call
            use(side)
            step(objs[side], inputs[0])
        if build:
            objs = [build() for _ in range(2)]
        times, launches = ([], []), ([], [])
        for rnd in range(3):
            for i, x in enumerate(inputs):
                for side in ((0, 1) if (rnd * len(inputs) + i) % 2 == 0 else (1, 0)):
                    use(side)
                    torch.cuda.synchronize()
                    _common.reset_dispatch_counters()
                    t0 = time.perf_counter()
                    step(objs[side], x)
                    torch.cuda.synchronize()
                    times[side].append((time.perf_counter() - t0) * 1e3)
                    launches[side].append(_common.dispatch_summary()["dispatch"])
        use(0)
        if launches[0] != launches[1]:
            print(f"[ab] {label}: the two rule forms launched differently: {launches[0][0]} against "
                  f"{launches[1][0]}", file=sys.stderr)
            return 1
        if build:
            for name, value in objs[0]._get_states().items() if hasattr(objs[0], "_get_states") else ():
                if not torch.equal(value, getattr(objs[1], name)):
                    print(f"[ab] {label}: state {name} differs between the rule forms", file=sys.stderr)
                    return 1
        summary(f"{label}, host ms per call (this: vmap_stack, other: autograd.Function)", times[0], times[1], "ms")
        print(f"[ab]   launches per call, each form: {launches[0][0]}")
    return 0


def trace_kernels(torch, fn, calls: int, sync_each: bool, path: str):
    """The device records (kernels, memsets, copies) of ``calls`` calls of ``fn``
    in the profiler's trace: how many there are and their spans (us)."""
    import json

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e["dur"] for e in events if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy") and "dur" in e]
    return len(spans), spans


def event_ms(torch, fn, calls: int, back_to_back: bool) -> float:
    """CUDA-event time (ms) per call: around each call alone (median), or
    around ``calls`` calls back to back (total over ``calls``)."""
    import statistics

    fn()
    torch.cuda.synchronize()
    if back_to_back:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiler_check() -> int:
    """``--profiler-check``: see the module docstring."""
    import statistics

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available; this script runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as c
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.kernels.binned_counts import label_score_histograms_batched_cuda

    print(c.card_line())
    _common.build_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(c.SEED)
    out_dir = os.path.join(ROOT, "build", "profiler_check")
    os.makedirs(out_dir, exist_ok=True)
    cases = []
    for label, r, n, k, dense in (("keyed binary rows", c.KEYED_ROWS, 1, 1, True),
                                  ("keyed 10-class rows", c.KEYED_ROWS, 1, c.KEYED_CLASSES, False),
                                  ("bootstrap resamples", c.BOOTSTRAPS, c.BATCH, c.NUM_CLASSES, False)):
        scores, labels = c._hist_batched_stack(torch, dev, r, n, k, dense, gen)
        out_bytes = 2 * r * k * c.NUM_BINS * 4 + r * 4
        in_bytes = scores.numel() * 4 + labels.numel() * labels.element_size()
        cases.append((f"B5 batched {label} ({r}, {n}, {k})", in_bytes + out_bytes,
                      lambda s=scores, t=labels: label_score_histograms_batched_cuda(s, t, c.NUM_BINS, device=dev)))
        buf = torch.empty(out_bytes // 4, device=dev)
        src = torch.ones_like(buf)
        cases.append((f"control: zero_ of {out_bytes / 1e6:.1f} MB", out_bytes, buf.zero_))
        cases.append((f"control: copy_ of {out_bytes / 1e6:.1f} MB", 2 * out_bytes, lambda b=buf, x=src: b.copy_(x)))
    for i, (label, nbytes, fn) in enumerate(cases):
        bound_ms = nbytes / c.PEAK_BYTES_PER_S * 1e3
        n_b2b, spans_b2b = trace_kernels(torch, fn, c.REPS, False, os.path.join(out_dir, f"{i}_b2b.json"))
        n_sync, spans_sync = trace_kernels(torch, fn, c.REPS, True, os.path.join(out_dir, f"{i}_sync.json"))
        alone = event_ms(torch, fn, c.REPS, back_to_back=False)
        b2b = event_ms(torch, fn, c.REPS, back_to_back=True)
        graph = c.graph_ms(fn)
        if not spans_b2b or not spans_sync:
            print(f"[profiler check] {label}: the trace holds no device record", file=sys.stderr)
            return 1
        print(f"[profiler check] {label}: bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB); profiler, {c.REPS} calls "
              f"back to back: {n_b2b} device records, mean span {statistics.mean(spans_b2b) / 1e3:.4f} ms, "
              f"sum per call {sum(spans_b2b) / c.REPS / 1e3:.4f} ms; synchronised after each call: {n_sync} records, "
              f"mean span {statistics.mean(spans_sync) / 1e3:.4f} ms; CUDA events around one call "
              f"{alone:.4f} ms, around {c.REPS} back to back {b2b:.4f} ms a call; replayed graph {graph:.4f} ms a call")
    return 0


def main() -> int:
    if sys.argv[1:] == ["--rule-forms"]:
        return rule_forms()
    if sys.argv[1:] == ["--profiler-check"]:
        return profiler_check()
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
