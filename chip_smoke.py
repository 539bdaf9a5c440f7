#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. Print the card (``nvidia-smi`` name and power limit), the PyTorch and CUDA
   versions; build the CUDA kernels from ``metrics_tpu_torch/csrc`` with
   ``nvcc`` and print the build time and the compiler's resource report.
2. Hold each kernel against its plain PyTorch version on the same CUDA
   tensors, at the main-path shapes and at ragged ones: exact equality, but
   for float sums of the segment scatter (B3), which add in an order that
   changes from run to run: within rtol=atol=1e-5 (a few float32 ulps of
   sums of a few terms), and run twice to print the run-to-run difference.
   B5's histograms must also equal the plain version run on the CPU (the
   plain version on the card divides by a device tensor, never by a Python
   scalar, whose CUDA division multiplies by the reciprocal), including at
   every bin edge and its float32 neighbours, and for NaN, +-inf and
   subnormal scores. The segment scatters (B3, B4) are held at every
   vector width B3 takes (D = 40, 8, 6, 4, 2, 1 at the keyed path's shapes,
   and ragged shapes), each with int64 and int32 ids and with rows 16-, 4-
   and 8-byte aligned (views that start one or two floats into a buffer).
3. The first path: ImageNet-1k evaluation (1000 classes, the 50,000-image
   validation split in batches of 1024 float32 softmax rows, 49 ``forward``
   calls, then ``compute()``) through
   ``MetricCollection({Accuracy, macro Precision/Recall/F1, ConfusionMatrix})``
   on the card. Each kernel must have launched exactly once per batch, and
   the results must equal the same collection run on the CPU over the same
   batches (counts exactly, float metrics within 1e-6).
   The per-``forward`` time of the collection, and under the profiler the
   device's busy share of ten forwards with the kernels that fill it.
3b. The keyed path, the serving entry point: ``MultiTenantCollection({Accuracy,
   macro Precision/Recall/F1})`` over 10,000 tenants, ten classes, on the
   card, ``validate_ids=False``; 50 ``update`` calls of 4096-row mixed
   batches (float32 softmax rows, int64 targets, tenant ids uniform in
   [0, 10000); the last batch holds 3000 real rows padded with id -1 and
   zero rows), then ``compute()``. B3 must launch once per bundle per update
   (100), B4 max once per update (50), B1 and B2 never; every multiclass row
   has one true class, so the Accuracy bundle's tp + fn over all tenants
   must count the real rows; the stacked states must equal the same
   collection's on the CPU exactly, the per-tenant values within 1e-6.
   The per-``update`` time, the ``compute()`` time, and the device's busy
   share of ten updates under the profiler.
3c. The sketched curve path: the same 49 ImageNet-1k batches through
   ``MetricCollection({AUROC, AveragePrecision})`` with ``num_classes=1000,
   sketched=True`` (2048 bins over (0, 1)) and ``compute_on_step=False``: 49
   ``update`` calls, then ``compute()``. B5 must launch twice per batch (98),
   B1-B4 never; the histogram states must equal the same collection's on the
   CPU exactly, the values within 1e-6. The per-``update`` time, the
   ``compute()`` time, the device's busy share of ten updates under the
   profiler, and (printed, not asserted) the exact list-mode AUROC of the
   same stream and its distance from the sketched one.
3d. The binary scorer stream: 100 updates of 10,000 seeded scores (labels
   Bernoulli(score)) into ``AUROC``, ``ROC`` and ``PrecisionRecallCurve``
   with ``sketched=True`` and into the exact ``AUROC()``. B5 must launch 300
   times; the sketched states must equal the CPU's exactly and the values
   within 1e-6; the sketched AUROC must lie within 5e-3 of the exact one.
4. Times at the main-path shapes: the median of 50 CUDA-event-timed calls
   of each kernel's wrapper, of its plain version and of the one PyTorch
   call that computes the same function (where there is one), each beside
   the least time the card could take; and the same calls' device time
   alone (kernels and memsets, by the profiler), which leaves out the
   host's launch cost. For B3 and B4 also the library call with its own
   output and index (``library_alloc_ms``), and the host time of each piece
   of their wrappers (1000 calls back to back, no synchronisation).
5. One JSON line ``{"kernels": [...]}``, the card line again, and, last,
   ``{"ok": true, "device": {...}}``.

With ``--record PATH`` the full record (every parity case, every forward's
time, the profile, the timings) is also written to PATH as JSON.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

NUM_CLASSES = 1000
NUM_SAMPLES = 50_000
BATCH = 1024
SEED = 20261016
#: H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, and the 32-bit
#: non-tensor-core rate used as the operations bound of integer work
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
REPS = 50
#: the keyed path: the repo's multitenant serving configuration
KEYED_TENANTS = 10_000
KEYED_ROWS = 4096
KEYED_CLASSES = 10
KEYED_UPDATES = 50
KEYED_LAST_REAL = 3000
#: the sketched curves: the class default grid, and the binary scorer stream
#: of the JAX package's bench_sketched_state_sync (1,000,000 scores in chunks
#: of 10,000)
NUM_BINS = 2048
STREAM_UPDATES = 100
STREAM_CHUNK = 10_000


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS, warmup: int = 5) -> float:
    """Median time of one call of ``fn`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_events(prof) -> list:
    """The device-side rows of a profile (kernels, memsets, copies), not the
    host operators that launched them (whose device time would count twice)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]


def _device_us(prof) -> float:
    """Device busy time (us) in a profile."""
    return sum(e.self_device_time_total for e in _device_events(prof))


def host_us(pieces, calls: int = 1000, warmup: int = 50) -> dict:
    """Host time (us per call) of each ``(name, fn)`` piece: ``calls`` calls
    back to back on the host clock, with no synchronisation in between (the
    device work a piece enqueues runs behind it and is not counted)."""
    import torch

    out = {}
    for name, fn in pieces:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - start) / calls * 1e6
        torch.cuda.synchronize()
    return out


def device_ms(fn, reps: int = REPS):
    """Device time of one call of ``fn`` (its kernels and memsets, without
    the host's launch cost) by the profiler; None if it saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = _device_us(prof)
    return total_us / reps / 1e3 if total_us > 0 else None


def bound(nbytes: int, nops: int) -> tuple:
    """The least time (ms) the card could take: bytes moved or operations done."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def make_batches(torch, device):
    """The 49 seeded ImageNet-1k-shaped batches: softmax rows whose true class
    gets a logit margin (about three quarters top-1 right), int64 targets."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    batches = []
    for start in range(0, NUM_SAMPLES, BATCH):
        n = min(BATCH, NUM_SAMPLES - start)
        target = torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device)
        logits = torch.randn((n, NUM_CLASSES), generator=gen, device=device)
        logits[torch.arange(n, device=device), target] += 4.0
        batches.append((torch.softmax(logits, dim=1), target))
    return batches


def build_collection(M, device):
    return M.MetricCollection({
        "Accuracy": M.Accuracy(device=device),
        "Precision": M.Precision(average="macro", num_classes=NUM_CLASSES, device=device),
        "Recall": M.Recall(average="macro", num_classes=NUM_CLASSES, device=device),
        "F1": M.F1(average="macro", num_classes=NUM_CLASSES, device=device),
        "ConfusionMatrix": M.ConfusionMatrix(num_classes=NUM_CLASSES, device=device),
    })


def make_keyed_batches(torch, device):
    """The 50 seeded 4096-row mixed batches of the keyed path: ``(tenant ids,
    softmax rows, int64 targets)``; the last holds 3000 real rows and is
    padded with id -1 and zero rows, as a ragged last cohort is."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    batches = []
    rows = torch.arange(KEYED_ROWS, device=device)
    for step in range(KEYED_UPDATES):
        ids = torch.randint(0, KEYED_TENANTS, (KEYED_ROWS,), generator=gen, device=device)
        target = torch.randint(0, KEYED_CLASSES, (KEYED_ROWS,), generator=gen, device=device)
        logits = torch.randn((KEYED_ROWS, KEYED_CLASSES), generator=gen, device=device)
        logits[rows, target] += 2.0
        preds = torch.softmax(logits, dim=1)
        if step == KEYED_UPDATES - 1:
            ids[KEYED_LAST_REAL:] = -1
            preds[KEYED_LAST_REAL:] = 0.0
            target[KEYED_LAST_REAL:] = 0
        batches.append((ids, preds, target))
    return batches


def build_keyed(M, device):
    kw = dict(average="macro", num_classes=KEYED_CLASSES, device=device)
    return M.MultiTenantCollection({
        "Accuracy": M.Accuracy(device=device),
        "Precision": M.Precision(**kw),
        "Recall": M.Recall(**kw),
        "F1": M.F1(**kw),
    }, num_tenants=KEYED_TENANTS, validate_ids=False, device=device)


def scatter_inputs(torch, gen, dev, r, s, d, floats=False, ids_dtype=None, offset=0):
    """Rows (integer-valued, or normal floats) that start ``offset`` floats
    into their buffer (1 leaves them 4-byte aligned, 2 8-byte aligned), and
    ids (int64, or ``ids_dtype``) uniform in [0, s) with -1, s and s+7 mixed
    in."""
    n = r * d
    if floats:
        buf = torch.randn((n + offset,), generator=gen, device=dev)
    else:
        buf = torch.randint(-2, 3, (n + offset,), generator=gen, device=dev).float()
    rows = buf[offset:offset + n].view(r, d)
    ids = torch.randint(0, s, (r,), generator=gen, device=dev)
    ids[0::97], ids[1::97], ids[2::97] = -1, s, s + 7
    return rows, ids if ids_dtype is None else ids.to(ids_dtype)


def special_rows(torch, dev):
    """NaN, signed zeros and infinities, routed so each case has a segment."""
    nan, inf = float("nan"), float("inf")
    cases = [(nan, 0), (1.0, 0), (2.0, 1), (nan, 1), (-0.0, 2), (0.0, 2), (0.0, 3), (-0.0, 3), (-0.0, 4),
             (0.0, 5), (inf, 6), (1.0, 6), (-inf, 7), (-1.0, 7), (inf, 8), (-inf, 8), (5.0, -1), (5.0, 12)]
    rows = torch.tensor([[v, -v] for v, _ in cases], device=dev)
    ids = torch.tensor([sid for _, sid in cases], device=dev)
    return rows, ids, 12  # segments 9..11 get no row


def scatter_host_pieces(torch, dev, ids):
    """The host-side pieces of the B3 and B4 wrappers at the keyed path's
    shapes (rows (4096, 40) and (4096, 1), 10,000 segments), each timed
    alone by :func:`host_us`, then the whole wrappers. The parent design's
    pieces (fills, the device context, the ``Stream`` object, the uncached
    capability query) are timed beside the pieces that replace them."""
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.kernels import segment_scatter as ss
    from metrics_tpu_torch.utilities.data import resolve_device

    s, d = KEYED_TENANTS, 40
    rows = torch.zeros((KEYED_ROWS, d), device=dev)
    rows1 = torch.zeros((KEYED_ROWS, 1), device=dev)
    out = torch.empty((s, d), device=dev)
    counts = torch.empty(s, dtype=torch.int32, device=dev)
    launch = _common.kernel_function(ss._ENTRY, ss._ARGTYPES)
    stream = _common.current_stream_handle(dev)
    args = (rows.data_ptr(), ids.data_ptr(), KEYED_ROWS, d, s, 8, ss._ADD, 4, out.data_ptr(), counts.data_ptr(),
            dev.index, stream)

    def device_context():
        with torch.cuda.device(dev):
            pass

    return [
        ("_kernel_device (resolved device)", lambda: ss._kernel_device(dev)),
        ("parent: resolve_device", lambda: resolve_device(dev)),
        ("_check (capability cached)", lambda: ss._check("segment_scatter_add", rows, ids, s, dev)),
        ("require_capability (cached)", lambda: _common.require_capability(dev)),
        ("torch.empty(S, 40) float32", lambda: torch.empty(s, d, dtype=torch.float32, device=dev)),
        ("torch.empty((S, 40)) float32, shape as a tuple", lambda: torch.empty((s, d), dtype=torch.float32,
                                                                              device=dev)),
        ("torch.empty(S) int32", lambda: torch.empty(s, dtype=torch.int32, device=dev)),
        ("data_ptr x4 + element_size", lambda: (rows.data_ptr(), ids.data_ptr(), out.data_ptr(), counts.data_ptr(),
                                                ids.element_size())),
        ("vector_width", lambda: ss.vector_width(d, args[0] | args[8])),
        ("kernel_function lookup", lambda: _common.kernel_function(ss._ENTRY, ss._ARGTYPES)),
        ("current_stream_handle", lambda: _common.current_stream_handle(dev)),
        ("ctypes call, S = 0 (returns early in C)", lambda: launch(*args[:4], 0, *args[5:])),
        ("ctypes call, D = 40 (device scope, one cooperative launch)", lambda: launch(*args)),
        ("launch counter", lambda: _common.note_kernel_dispatch("host_pieces_probe", "cuda")),
        ("segment_scatter_add_cuda D=40, whole", lambda: ss.segment_scatter_add_cuda(rows, ids, s, device=dev)),
        ("segment_scatter_max_cuda D=1, whole", lambda: ss.segment_scatter_max_cuda(rows1, ids, s, device=dev)),
        ("parent: torch.cuda.get_device_capability", lambda: torch.cuda.get_device_capability(dev)),
        ("parent: torch.zeros (S, 40) float32", lambda: torch.zeros((s, d), dtype=torch.float32, device=dev)),
        ("parent: torch.zeros (S,) int32", lambda: torch.zeros(s, dtype=torch.int32, device=dev)),
        ("parent: torch.full (S, 1) -inf", lambda: torch.full((s, 1), float("-inf"), device=dev)),
        ("parent: torch.cuda.device context", device_context),
        ("parent: torch.cuda.current_stream(dev).cuda_stream", lambda: torch.cuda.current_stream(dev).cuda_stream),
    ]


def build_curves(M, device):
    kw = dict(num_classes=NUM_CLASSES, sketched=True, num_bins=NUM_BINS, compute_on_step=False, device=device)
    return M.MetricCollection({"AUROC": M.AUROC(**kw), "AveragePrecision": M.AveragePrecision(**kw)})


def build_stream(M, device):
    kw = dict(sketched=True, num_bins=NUM_BINS, device=device)
    return {"AUROC": M.AUROC(**kw), "ROC": M.ROC(**kw), "PrecisionRecallCurve": M.PrecisionRecallCurve(**kw)}


def make_stream(torch, device):
    """The 100 seeded chunks of the binary scorer stream: uniform scores,
    labels Bernoulli(score), int64."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    chunks = []
    for _ in range(STREAM_UPDATES):
        scores = torch.rand(STREAM_CHUNK, generator=gen, device=device)
        labels = (torch.rand(STREAM_CHUNK, generator=gen, device=device) < scores).long()
        chunks.append((scores, labels))
    return chunks


def edge_scores(torch, dev, b, lo, hi):
    """Every bin edge of the grid with its float32 neighbours, then NaN,
    +-inf, signed zeros, subnormals and scores outside [lo, hi]."""
    edges = (lo + (hi - lo) * torch.arange(b + 1, dtype=torch.float64, device=dev) / b).float()
    up = torch.nextafter(edges, torch.full_like(edges, float("inf")))
    down = torch.nextafter(edges, torch.full_like(edges, float("-inf")))
    special = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1e-45, -1e-45, -1e-39, -1e-30,
                            lo - 1.0, hi + 1.0], device=dev)
    return torch.cat([edges, up, down, special])


def trees_equal(torch, got, want) -> bool:
    """Equal structure and dtypes, values equal exactly."""
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(trees_equal(torch, g, w) for g, w in zip(got, want))
    return got.dtype == want.dtype and got.shape == want.shape and bool(torch.equal(got.cpu(), want))


def tree_max_diff(torch, got, want) -> float:
    """Largest |got - want| over a (nested) tuple of tensors; raises on a shape or NaN mismatch."""
    if isinstance(want, (list, tuple)):
        return max(tree_max_diff(torch, g, w) for g, w in zip(got, want))
    got = got.cpu()
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got.isnan(), want.isnan()):
        fail(f"{tuple(got.shape)} {got.dtype} on the card against {tuple(want.shape)} {want.dtype} on the CPU, "
             "or NaN in other places")
    return float(torch.nan_to_num(got - want).abs().max()) if got.numel() else 0.0


def profile_steps(torch, step, inputs):
    """Wall time, device busy time and the top device rows of ``step`` over ``inputs``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for args in inputs:
            step(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    busy_ms = _device_us(prof) / 1e3
    top = sorted(_device_events(prof), key=lambda e: -e.self_device_time_total)[:10]
    breakdown = [{"name": e.key[:80], "calls": e.count, "device_us": e.self_device_time_total} for e in top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "top_device": breakdown}


def same_bits(a, b) -> bool:
    """Equal values, NaN where NaN (of either sign: a NaN's sign bit and
    payload carry nothing), and the same sign of zero."""
    import torch

    return (a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a.isnan(), b.isnan()))
            and bool(torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)))
            and bool(torch.equal(torch.signbit(a) & ~a.isnan(), torch.signbit(b) & ~b.isnan())))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", help="also write the full record to this JSON file")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on an NVIDIA GPU only", file=sys.stderr)
        return 1

    import metrics_tpu_torch as M
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.kernels.binned_counts import label_score_histograms_cuda, label_score_histograms_torch
    from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_cuda, confmat_counts_torch
    from metrics_tpu_torch.kernels.segment_scatter import (
        segment_scatter_add_cuda,
        segment_scatter_add_torch,
        segment_scatter_max_cuda,
        segment_scatter_max_torch,
        segment_scatter_min_cuda,
        segment_scatter_min_torch,
        vector_width,
    )
    from metrics_tpu_torch.kernels.stat_scores import stat_scores_counts_cuda, stat_scores_counts_torch
    from metrics_tpu_torch.utilities.checks import _input_format_classification

    record = {}
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"capability {torch.cuda.get_device_capability(0)}")
    record["card"] = card

    # -- 1. build --------------------------------------------------------
    start = time.perf_counter()
    lib_path, log = _common.build_library()
    build_s = time.perf_counter() - start
    print(f"[build] {lib_path.name} in {build_s:.2f} s")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")
    record["build_s"] = build_s
    dev = torch.device("cuda", 0)

    # -- 2. kernel vs plain on the card --------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    errors = {"stat_scores_counts": 0, "confmat_counts": 0}
    parity = []
    for n, c in [(1024, 1000), (1, 1), (1023, 129), (4096, 2048)]:
        preds = torch.randint(0, 2, (n, c), generator=gen, device=dev, dtype=torch.int32)
        target = torch.randint(0, 2, (n, c), generator=gen, device=dev, dtype=torch.int32)
        got = stat_scores_counts_cuda(preds, target, device=dev)
        torch.cuda.synchronize()
        want = stat_scores_counts_torch(preds, target)
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        ok = all(torch.equal(g, w) and g.dtype == torch.int32 for g, w in zip(got, want))
        errors["stat_scores_counts"] = max(errors["stat_scores_counts"], err)
        parity.append({"kernel": "stat_scores_counts", "shape": [n, c], "equal": ok})
        print(f"[parity] stat_scores_counts N={n} C={c}: {'equal' if ok else 'DIFFERENT'}")
        if not ok:
            fail(f"stat_scores_counts differs from its plain version at N={n}, C={c}")
    for n, c, dtype, low, high in [
        (1024, 1000, torch.int64, 0, 1000), (1024, 3, torch.int64, 0, 3), (1024, 64, torch.int64, 0, 64),
        (1, 1000, torch.int64, 0, 1000), (4099, 64, torch.int32, 0, 64),
        (4099, 1000, torch.int32, -2, 1002),  # out-of-range pairs are dropped by both
    ]:
        preds = torch.randint(low, high, (n,), generator=gen, device=dev, dtype=dtype)
        target = torch.randint(low, high, (n,), generator=gen, device=dev, dtype=dtype)
        got = confmat_counts_cuda(preds, target, c, device=dev)
        torch.cuda.synchronize()
        want = confmat_counts_torch(preds, target, c)
        err = int((got.long() - want.long()).abs().max())
        ok = torch.equal(got, want) and got.dtype == torch.int32
        errors["confmat_counts"] = max(errors["confmat_counts"], err)
        parity.append({"kernel": "confmat_counts", "n": n, "num_classes": c, "dtype": str(dtype),
                       "labels": [low, high], "equal": ok})
        print(f"[parity] confmat_counts N={n} C={c} {dtype} labels in [{low}, {high}): "
              f"{'equal' if ok else 'DIFFERENT'}")
        if not ok:
            fail(f"confmat_counts differs from its plain version at N={n}, C={c}")

    scatter = {"segment_scatter_add": (segment_scatter_add_cuda, segment_scatter_add_torch),
               "segment_scatter_max": (segment_scatter_max_cuda, segment_scatter_max_torch),
               "segment_scatter_min": (segment_scatter_min_cuda, segment_scatter_min_torch)}
    # the keyed path's shapes at every vector width B3 takes, ragged shapes;
    # each with int64 and int32 ids, and rows 16-, 4- and 8-byte aligned
    scatter_cases = [(KEYED_ROWS, KEYED_TENANTS, d) for d in (40, 8, 6, 4, 2, 1)] + [
        (1, 1, 1), (4099, 100_000, 3), (300, 64, 16)]
    for op, (kernel, plain) in scatter.items():
        errors[op] = 0.0
        for r, s, d in scatter_cases:
            widths = set()
            for ids_dtype in (torch.int64, torch.int32):
                for offset in (0, 1, 2):
                    rows, ids = scatter_inputs(torch, gen, dev, r, s, d, ids_dtype=ids_dtype, offset=offset)
                    got = kernel(rows, ids, s, device=dev)
                    torch.cuda.synchronize()
                    want = plain(rows, ids, s)
                    ok = all(same_bits(g, w) for g, w in zip(got, want))
                    width = vector_width(d, rows.data_ptr() | got[0].data_ptr()) if op == "segment_scatter_add" else 1
                    widths.add(width)
                    parity.append({"kernel": op, "shape": [r, s, d], "rows": "integer-valued", "ids": str(ids_dtype),
                                   "row_offset_bytes": 4 * offset, "vector_width": width, "equal": ok})
                    if not ok:
                        fail(f"{op} differs from its plain version at R={r}, S={s}, D={d}, {ids_dtype} ids, rows "
                             f"{4 * offset} bytes into their buffer")
            print(f"[parity] {op} R={r} S={s} D={d} integer-valued rows, invalid ids; int64 and int32 ids, rows at "
                  f"byte offsets 0, 4 and 8 (vector widths {sorted(widths)}): equal")
        if op == "segment_scatter_add":
            rows, ids = scatter_inputs(torch, gen, dev, KEYED_ROWS, KEYED_TENANTS, 40, floats=True)
            first, counts = kernel(rows, ids, KEYED_TENANTS, device=dev)
            second, _ = kernel(rows, ids, KEYED_TENANTS, device=dev)
            want, want_counts = plain(rows, ids, KEYED_TENANTS)
            torch.cuda.synchronize()
            err = float((first - want).abs().max())
            rerun = float((first - second).abs().max())
            ok = torch.allclose(first, want, rtol=1e-5, atol=1e-5) and torch.equal(counts, want_counts)
            errors[op] = max(errors[op], err)
            parity.append({"kernel": op, "shape": [KEYED_ROWS, KEYED_TENANTS, 40], "rows": "float",
                           "max_abs_err": err, "run_to_run_max_abs_diff": rerun, "equal": ok})
            print(f"[parity] {op} R={KEYED_ROWS} S={KEYED_TENANTS} D=40 float rows: max |kernel - plain| {err:.3e} "
                  f"(rtol=atol=1e-5), run-to-run max |diff| {rerun:.3e}")
            if not ok:
                fail(f"{op} float sums differ from the plain version beyond the tolerance")
        else:
            rows, ids, s = special_rows(torch, dev)
            got = kernel(rows, ids, s, device=dev)
            torch.cuda.synchronize()
            ok = all(same_bits(g, w) for g, w in zip(got, plain(rows, ids, s)))
            parity.append({"kernel": op, "rows": "NaN, +-0.0, +-inf, invalid ids", "equal": ok})
            print(f"[parity] {op} NaN, +-0.0 and +-inf rows, empty segments: {'equal' if ok else 'DIFFERENT'}")
            if not ok:
                fail(f"{op} differs from its plain version on NaN, signed-zero or infinite rows")

    # B5: kernel == plain on the card == plain on the CPU, bit for bit
    errors["label_score_histograms"] = 0.0
    hist_cases = []
    for n, c, b in [(BATCH, NUM_CLASSES, NUM_BINS), (STREAM_CHUNK, 1, NUM_BINS), (1, 3, 4096), (7, 3, 4096),
                    (1023, 3, 4096)]:
        scores = torch.rand((n, c), generator=gen, device=dev)
        labels = torch.randint(0, 2, (n, c), generator=gen, device=dev, dtype=torch.int32)
        hist_cases.append((f"N={n} C={c} B={b} uniform scores", scores, labels, b, 0.0, 1.0))
    for b, lo, hi in [(NUM_BINS, 0.0, 1.0), (1000, 0.0, 1.0), (4096, 0.1, 0.7)]:
        scores = edge_scores(torch, dev, b, lo, hi).reshape(-1, 1)
        labels = (torch.arange(scores.shape[0], device=dev) % 2).int().reshape(-1, 1)
        hist_cases.append((f"every edge of B={b} over ({lo}, {hi}) with neighbours, NaN, +-inf, subnormals",
                           scores, labels, b, lo, hi))
    scores = torch.randn((4096, 3), generator=gen, device=dev) * 3
    scores[::101] = float("nan")
    scores[1::103] = float("inf")
    hist_cases.append(("N=4096 C=3 B=32 over (-2, 2), out of range, NaN, inf", scores,
                       torch.randint(0, 2, (4096, 3), generator=gen, device=dev), 32, -2.0, 2.0))
    hist_cases.append(("N=1024 C=1000 B=2048 bf16 scores, float32 targets",
                       torch.rand((BATCH, NUM_CLASSES), generator=gen, device=dev).bfloat16(),
                       torch.randint(0, 2, (BATCH, NUM_CLASSES), generator=gen, device=dev).float(), NUM_BINS, 0.0,
                       1.0))
    for label, scores, labels, b, lo, hi in hist_cases:
        got = label_score_histograms_cuda(scores, labels, b, lo, hi, device=dev)
        torch.cuda.synchronize()
        want = label_score_histograms_torch(scores, labels, b, lo, hi)
        want_cpu = label_score_histograms_torch(scores.cpu(), labels.cpu(), b, lo, hi)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = trees_equal(torch, got, want_cpu) and all(torch.equal(g, w) for g, w in zip(got, want))
        errors["label_score_histograms"] = max(errors["label_score_histograms"], err)
        parity.append({"kernel": "label_score_histograms", "case": label, "equal": ok, "max_abs_err": err,
                       "clipped": float(got[2])})
        print(f"[parity] label_score_histograms {label}: {'equal' if ok else 'DIFFERENT'} "
              f"(kernel == plain on the card == plain on the CPU; clipped {float(got[2]):.0f})")
        if not ok:
            fail(f"label_score_histograms differs from its plain version: {label}")
    record["parity"] = parity

    # -- 3. the main path -------------------------------------------------
    batches = make_batches(torch, dev)
    if len(batches) != 49 or batches[-1][0].shape[0] != 848:
        fail("the epoch is not 48 batches of 1024 and one of 848")
    gpu = build_collection(M, dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    step_ms = []
    for preds, target in batches:
        start = time.perf_counter()
        gpu(preds, target)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
    start = time.perf_counter()
    gpu_out = gpu.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - start) * 1e3
    launches = {op: _common.launch_count(op) for op in ("stat_scores_counts", "confmat_counts")}
    print(f"[main] 49 forward + compute on {kind}: launches {launches}; forward median "
          f"{statistics.median(step_ms):.3f} ms (first {step_ms[0]:.3f} ms), compute {compute_ms:.3f} ms")
    for op, count in launches.items():
        if count != len(batches):
            fail(f"{op} launched {count} times on the main path, expected {len(batches)}")

    cpu = build_collection(M, "cpu")
    for preds, target in batches:
        cpu(preds.cpu(), target.cpu())
    cpu_out = cpu.compute()
    diffs = {}
    for name, value in gpu_out.items():
        got, want = value.cpu(), cpu_out[name]
        if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got.float()).all():
            fail(f"{name}: {tuple(got.shape)} {got.dtype} on the card against {tuple(want.shape)} {want.dtype}")
        if name == "ConfusionMatrix":
            if not torch.equal(got, want):
                fail("the confusion matrix on the card differs from the CPU's")
            diffs[name] = 0.0
        else:
            diffs[name] = float((got - want).abs().max())
            if diffs[name] > 1e-6:
                fail(f"{name}: {got.item()} on the card, {want.item()} on the CPU")
    confmat = gpu_out["ConfusionMatrix"]
    if int(confmat.sum()) != NUM_SAMPLES:
        fail("the confusion matrix does not count every sample once")
    top1 = float(confmat.diagonal().sum()) / NUM_SAMPLES
    if abs(top1 - float(gpu_out["Accuracy"])) > 1e-6:
        fail(f"Accuracy {float(gpu_out['Accuracy'])} disagrees with the confusion matrix's {top1}")
    values = {k: float(v) for k, v in gpu_out.items() if v.ndim == 0}
    print(f"[main] card == CPU (max |diff| {diffs}); values {values}")
    record["main"] = {"launches": launches, "forward_ms": step_ms, "compute_ms": compute_ms,
                      "values": values, "max_abs_diff_vs_cpu": diffs}

    # where a forward's time goes: device busy share over 10 steady forwards
    from torch.profiler import ProfilerActivity, profile

    probe = build_collection(M, dev)
    probe(*batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for preds, target in batches[1:11]:
            probe(preds, target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    busy_ms = _device_us(prof) / 1e3
    top = sorted(_device_events(prof), key=lambda e: -e.self_device_time_total)[:10]
    breakdown = [{"name": e.key[:80], "calls": e.count, "device_us": e.self_device_time_total} for e in top]
    print(f"[main] 10 forwards under the profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for row in breakdown:
        print(f"[main]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
    record["main"]["profile"] = {"forwards": 10, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                                 "top_device": breakdown}

    # -- 3b. the keyed path ------------------------------------------------------
    keyed_batches = make_keyed_batches(torch, dev)
    real_rows = (KEYED_UPDATES - 1) * KEYED_ROWS + KEYED_LAST_REAL
    keyed_gpu = build_keyed(M, dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    update_ms = []
    for ids, preds, target in keyed_batches:
        start = time.perf_counter()
        keyed_gpu.update(ids, preds, target)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - start) * 1e3)
    start = time.perf_counter()
    keyed_out = keyed_gpu.compute()
    torch.cuda.synchronize()
    keyed_compute_ms = (time.perf_counter() - start) * 1e3
    keyed_ops = ("segment_scatter_add", "segment_scatter_max", "segment_scatter_min", "stat_scores_counts",
                 "confmat_counts")
    keyed_launches = {op: _common.launch_count(op) for op in keyed_ops}
    print(f"[keyed] {KEYED_UPDATES} update of {KEYED_ROWS} rows into {KEYED_TENANTS} tenants + compute on {kind}: "
          f"launches {keyed_launches}; update median {statistics.median(update_ms):.3f} ms "
          f"(first {update_ms[0]:.3f} ms), compute {keyed_compute_ms:.3f} ms")
    expected = {"segment_scatter_add": 2 * KEYED_UPDATES, "segment_scatter_max": KEYED_UPDATES,
                "segment_scatter_min": 0, "stat_scores_counts": 0, "confmat_counts": 0}
    for op, count in expected.items():
        if keyed_launches[op] != count:
            fail(f"{op} launched {keyed_launches[op]} times on the keyed path, expected {count}")
    if keyed_gpu.state_bundles != 2:
        fail(f"the keyed collection holds {keyed_gpu.state_bundles} state bundles, expected 2")
    acc = keyed_gpu._keyed["Accuracy"]
    counted = int((acc.tp.long() + acc.fn.long()).sum())
    if counted != real_rows:
        fail(f"the Accuracy bundle counts {counted} rows, expected the {real_rows} real rows")

    keyed_cpu = build_keyed(M, "cpu")
    for ids, preds, target in keyed_batches:
        keyed_cpu.update(ids.cpu(), preds.cpu(), target.cpu())
    cpu_out = keyed_cpu.compute()
    for owner, km in keyed_gpu._keyed.items():
        for name, value in km._get_states().items():
            want = getattr(keyed_cpu._keyed[owner], name)
            if value.dtype != want.dtype or not torch.equal(value.cpu(), want):
                fail(f"keyed state {owner}.{name} on the card differs from the CPU's")
    keyed_diffs = {}
    for name, value in keyed_out.items():
        got, want = value.cpu(), cpu_out[name]
        if got.shape != (KEYED_TENANTS,) or got.dtype != want.dtype or not torch.equal(got.isnan(), want.isnan()):
            fail(f"keyed {name}: {tuple(got.shape)} {got.dtype} on the card, NaN where the CPU's is not, or the reverse")
        keyed_diffs[name] = float(torch.nan_to_num(got - want).abs().max())
        if keyed_diffs[name] > 1e-6:
            fail(f"keyed {name} differs from the CPU's by {keyed_diffs[name]}")
    means = {name: float(value[~value.isnan()].mean()) for name, value in keyed_out.items()}
    print(f"[keyed] card == CPU (states exact; values max |diff| {keyed_diffs}); tp + fn over tenants = "
          f"{counted} real rows; tenant means {means}")
    record["keyed"] = {"launches": keyed_launches, "update_ms": update_ms, "compute_ms": keyed_compute_ms,
                       "real_rows": counted, "tenant_means": means, "max_abs_diff_vs_cpu": keyed_diffs}

    probe = build_keyed(M, dev)
    probe.update(*keyed_batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for ids, preds, target in keyed_batches[1:11]:
            probe.update(ids, preds, target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    busy_ms = _device_us(prof) / 1e3
    top = sorted(_device_events(prof), key=lambda e: -e.self_device_time_total)[:10]
    breakdown = [{"name": e.key[:80], "calls": e.count, "device_us": e.self_device_time_total} for e in top]
    print(f"[keyed] 10 updates under the profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for row in breakdown:
        print(f"[keyed]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
    record["keyed"]["profile"] = {"updates": 10, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                                  "top_device": breakdown}

    # -- 3c. the sketched curve path ------------------------------------------
    all_ops = ("stat_scores_counts", "confmat_counts", "segment_scatter_add", "segment_scatter_max",
               "segment_scatter_min", "label_score_histograms")
    curves_gpu = build_curves(M, dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    curve_update_ms = []
    for preds, target in batches:
        start = time.perf_counter()
        curves_gpu.update(preds, target)
        torch.cuda.synchronize()
        curve_update_ms.append((time.perf_counter() - start) * 1e3)
    start = time.perf_counter()
    curves_out = curves_gpu.compute()
    torch.cuda.synchronize()
    curves_compute_ms = (time.perf_counter() - start) * 1e3
    curve_launches = {op: _common.launch_count(op) for op in all_ops}
    print(f"[curves] 49 update + compute of sketched AUROC + AveragePrecision (C={NUM_CLASSES}, B={NUM_BINS}) on "
          f"{kind}: launches {curve_launches}; update median {statistics.median(curve_update_ms):.3f} ms "
          f"(first {curve_update_ms[0]:.3f} ms), compute {curves_compute_ms:.3f} ms")
    for op, count in curve_launches.items():
        want = 2 * len(batches) if op == "label_score_histograms" else 0
        if count != want:
            fail(f"{op} launched {count} times on the curve path, expected {want}")

    curves_cpu = build_curves(M, "cpu")
    for preds, target in batches:
        curves_cpu.update(preds.cpu(), target.cpu())
    curves_cpu_out = curves_cpu.compute()
    for name in ("AUROC", "AveragePrecision"):
        for state in ("pos_hist", "neg_hist", "sketch_clipped"):
            if not trees_equal(torch, getattr(curves_gpu[name], state), getattr(curves_cpu[name], state)):
                fail(f"sketched state {name}.{state} on the card differs from the CPU's")
    curve_diffs = {name: tree_max_diff(torch, curves_out[name], curves_cpu_out[name]) for name in curves_out}
    if max(curve_diffs.values()) > 1e-6 or not all(bool(torch.isfinite(v).all()) for v in curves_out.values()):
        fail(f"sketched curve values differ from the CPU's by {curve_diffs} or are not finite")
    if curves_out["AveragePrecision"].shape != (NUM_CLASSES,):
        fail(f"AveragePrecision has the shape {tuple(curves_out['AveragePrecision'].shape)}")
    pos_total = float(curves_gpu["AUROC"].pos_hist.sum())
    neg_total = float(curves_gpu["AUROC"].neg_hist.sum())
    if pos_total != NUM_SAMPLES or neg_total != NUM_SAMPLES * (NUM_CLASSES - 1):
        fail(f"the histograms count {pos_total} positives and {neg_total} negatives")
    sketched_auroc = float(curves_out["AUROC"])
    mean_ap = float(curves_out["AveragePrecision"].mean())
    state_bytes = sum(getattr(curves_gpu[n], s).numel() * 4 for n in curves_out
                      for s in ("pos_hist", "neg_hist", "sketch_clipped"))
    print(f"[curves] card == CPU (histograms exact; values max |diff| {curve_diffs}); "
          f"macro AUROC {sketched_auroc:.6f}, "
          f"mean AP {mean_ap:.6f}; sketched state {state_bytes} bytes on the card")
    curve_profile = profile_steps(torch, curves_gpu.update, batches[1:11])
    print(f"[curves] 10 updates under the profiler: wall {curve_profile['wall_ms']:.3f} ms, device busy "
          f"{curve_profile['device_busy_ms']:.3f} ms (idle share "
          f"{1 - curve_profile['device_busy_ms'] / curve_profile['wall_ms']:.3f})")
    for row in curve_profile["top_device"]:
        print(f"[curves]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
    exact = M.AUROC(num_classes=NUM_CLASSES, compute_on_step=False, device=dev)
    for preds, target in batches:
        exact.update(preds, target)
    start = time.perf_counter()
    exact_auroc = float(exact.compute())
    exact_compute_ms = (time.perf_counter() - start) * 1e3
    del exact
    print(f"[curves] exact list-mode macro AUROC {exact_auroc:.6f} (compute {exact_compute_ms:.1f} ms); "
          f"|sketched - exact| = {abs(sketched_auroc - exact_auroc):.3e}")
    record["curves"] = {"launches": curve_launches, "update_ms": curve_update_ms, "compute_ms": curves_compute_ms,
                        "auroc": sketched_auroc, "mean_ap": mean_ap, "max_abs_diff_vs_cpu": curve_diffs,
                        "state_bytes": state_bytes, "profile": curve_profile, "exact_auroc": exact_auroc,
                        "exact_compute_ms": exact_compute_ms, "sketched_minus_exact": sketched_auroc - exact_auroc}

    # -- 3d. the binary scorer stream ----------------------------------------------
    chunks = make_stream(torch, dev)
    stream_gpu = build_stream(M, dev)
    stream_exact = M.AUROC(compute_on_step=False, device=dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    stream_update_ms = []
    for scores, labels in chunks:
        start = time.perf_counter()
        for m in stream_gpu.values():
            m.update(scores, labels)
        torch.cuda.synchronize()
        stream_update_ms.append((time.perf_counter() - start) * 1e3)
        stream_exact.update(scores, labels)
    stream_launches = {op: _common.launch_count(op) for op in all_ops}
    stream_out = {name: m.compute() for name, m in stream_gpu.items()}
    stream_exact_auroc = float(stream_exact.compute())
    print(f"[stream] {STREAM_UPDATES} updates of {STREAM_CHUNK} scores into sketched AUROC + ROC + "
          f"PrecisionRecallCurve on {kind}: launches {stream_launches}; update median (three metrics) "
          f"{statistics.median(stream_update_ms):.3f} ms")
    for op, count in stream_launches.items():
        want = 3 * STREAM_UPDATES if op == "label_score_histograms" else 0
        if count != want:
            fail(f"{op} launched {count} times on the binary stream, expected {want}")
    stream_cpu = build_stream(M, "cpu")
    for scores, labels in chunks:
        for m in stream_cpu.values():
            m.update(scores.cpu(), labels.cpu())
    for name, m in stream_gpu.items():
        for state in ("pos_hist", "neg_hist", "sketch_clipped"):
            if not trees_equal(torch, getattr(m, state), getattr(stream_cpu[name], state)):
                fail(f"sketched state {name}.{state} of the binary stream differs from the CPU's")
    stream_diffs = {name: tree_max_diff(torch, stream_out[name], stream_cpu[name].compute()) for name in stream_out}
    if max(stream_diffs.values()) > 1e-6:
        fail(f"binary stream values differ from the CPU's by {stream_diffs}")
    stream_auroc = float(stream_out["AUROC"])
    gap = abs(stream_auroc - stream_exact_auroc)
    stream_state_bytes = sum(getattr(stream_gpu["AUROC"], s).numel() * 4 for s in ("pos_hist", "neg_hist",
                                                                                    "sketch_clipped"))
    print(f"[stream] card == CPU (states exact; values max |diff| {stream_diffs}); sketched AUROC {stream_auroc:.6f}, "
          f"exact {stream_exact_auroc:.6f}, |diff| {gap:.3e} (limit 5e-3); sketched state {stream_state_bytes} bytes "
          f"per metric, whatever the count of scores (the exact state holds "
          f"{STREAM_UPDATES * STREAM_CHUNK * 12} bytes)")
    if gap > 5e-3:
        fail(f"the sketched AUROC of the binary stream is {gap} from the exact one")
    if stream_state_bytes != 2 * NUM_BINS * 4 + 4:
        fail(f"the sketched state holds {stream_state_bytes} bytes")
    del stream_exact
    record["stream"] = {"launches": stream_launches, "update_ms": stream_update_ms, "auroc": stream_auroc,
                        "exact_auroc": stream_exact_auroc, "max_abs_diff_vs_cpu": stream_diffs,
                        "state_bytes_per_metric": stream_state_bytes}

    # -- 4. times at the main-path shapes ------------------------------------
    preds, target = batches[0]
    canon_p, canon_t, _ = _input_format_classification(preds, target)
    canon_p, canon_t = canon_p.contiguous(), canon_t.contiguous()
    labels_p, labels_t = canon_p.argmax(dim=1), canon_t.argmax(dim=1)
    n, c = canon_p.shape
    flat = labels_t * c + labels_p

    b1_bound = bound(2 * n * c * 4 + 4 * c * 4, 5 * n * c)
    b2_bound = bound(2 * n * 8 + c * c * 4, 6 * n)
    calls = {
        "stat_scores_counts": {
            "ms": lambda: stat_scores_counts_cuda(canon_p, canon_t, device=dev),
            "plain_ms": lambda: stat_scores_counts_torch(canon_p, canon_t),
            "library_ms": None,
        },
        "confmat_counts": {
            "ms": lambda: confmat_counts_cuda(labels_p, labels_t, c, device=dev),
            "plain_ms": lambda: confmat_counts_torch(labels_p, labels_t, c),
            "library_ms": lambda: torch.bincount(flat, minlength=c * c),
        },
    }
    timings = {
        "stat_scores_counts": {"bound": b1_bound, "shape": f"preds, target ({n}, {c}) int32"},
        "confmat_counts": {"bound": b2_bound, "shape": f"preds, target ({n},) int64, C={c}"},
    }
    # the keyed path's shapes: its ids, and rows of 0/1-valued deltas
    s_ = KEYED_TENANTS
    keyed_ids = keyed_batches[0][0]
    safe = torch.where((keyed_ids >= 0) & (keyed_ids < s_), keyed_ids, s_)
    for op, d in (("segment_scatter_add", 40), ("segment_scatter_add_d6", 6), ("segment_scatter_max", 1),
                  ("segment_scatter_min", 1)):
        kernel_op = op.replace("_d6", "")
        kernel, plain = scatter[kernel_op]
        rows = torch.randint(0, 2, (KEYED_ROWS, d), generator=gen, device=dev).float()
        buffer = torch.zeros((s_ + 1, d), device=dev)
        # library_ms: the one call into a buffer allocated once, the safe
        # index made outside the timed region; library_alloc_ms: the same
        # call with its own output (zeros or a -inf/+inf fill of (S+1, D))
        # and the safe index made per call, as a caller pays them (neither
        # counts the rows per segment, as the kernels also do)
        if kernel_op == "segment_scatter_add":
            library = (lambda buffer=buffer, rows=rows: buffer.index_add_(0, safe, rows))

            def library_alloc(rows=rows, d=d):
                ids = torch.where((keyed_ids >= 0) & (keyed_ids < s_), keyed_ids, s_)
                return torch.zeros((s_ + 1, d), device=dev).index_add_(0, ids, rows)
        else:
            index = safe.unsqueeze(1).expand(-1, d).contiguous()
            how = "amax" if kernel_op.endswith("max") else "amin"
            library = (lambda buffer=buffer, index=index, rows=rows, how=how:
                       buffer.scatter_reduce_(0, index, rows, how, include_self=True))

            def library_alloc(rows=rows, d=d, how=how):
                ids = torch.where((keyed_ids >= 0) & (keyed_ids < s_), keyed_ids, s_)
                out = torch.full((s_ + 1, d), float("-inf") if how == "amax" else float("inf"), device=dev)
                return out.scatter_reduce_(0, ids.unsqueeze(1).expand(-1, d), rows, how, include_self=True)
        nbytes = KEYED_ROWS * d * 4 + KEYED_ROWS * 8 + s_ * d * 4 + s_ * 4
        calls[op] = {
            "ms": lambda kernel=kernel, rows=rows: kernel(rows, keyed_ids, s_, device=dev),
            "plain_ms": lambda plain=plain, rows=rows: plain(rows, keyed_ids, s_),
            "library_ms": library,
            "library_alloc_ms": library_alloc,
        }
        timings[op] = {"bound": bound(nbytes, KEYED_ROWS * d), "shape": f"rows ({KEYED_ROWS}, {d}) float32, ids "
                       f"({KEYED_ROWS},) int64, S={s_}"}
    # B5 at the curve path's shape (one ImageNet-1k batch, one-hot int32
    # targets, as AUROC/AveragePrecision hand it over) and at the binary
    # stream's; the library call counts the flat (label, class, bin) index,
    # computed outside the timed region: no bucketize, no NaN rule, no
    # clipped count
    from metrics_tpu_torch.kernels.binned_counts import _bin_index

    onehot = (batches[0][1].unsqueeze(1) == torch.arange(NUM_CLASSES, device=dev)).to(torch.int32)
    for op, scores, labels in (("label_score_histograms", batches[0][0], onehot),
                               ("label_score_histograms_c1", chunks[0][0].reshape(-1, 1),
                                chunks[0][1].reshape(-1, 1).to(torch.int32))):
        n, c = scores.shape
        cells = c * NUM_BINS
        flat = (torch.where(labels == 1, 0, cells) + torch.arange(c, device=dev) * NUM_BINS
                + _bin_index(scores, NUM_BINS, 0.0, 1.0)).reshape(-1)
        calls[op] = {
            "ms": lambda scores=scores, labels=labels: label_score_histograms_cuda(scores, labels, NUM_BINS,
                                                                                   device=dev),
            "plain_ms": lambda scores=scores, labels=labels: label_score_histograms_torch(scores, labels, NUM_BINS),
            "library_ms": lambda flat=flat, cells=cells: torch.bincount(flat, minlength=2 * cells),
        }
        timings[op] = {"bound": bound(2 * n * c * 4 + 2 * cells * 4 + 4, 4 * n * c),
                       "shape": f"scores ({n}, {c}) float32, targets ({n}, {c}) int32, B={NUM_BINS}"}
    for op, fns in calls.items():
        t = timings[op]
        for key, fn in fns.items():
            t[key] = None if fn is None else cuda_ms(fn)
            t[key.replace("ms", "device_ms")] = None if fn is None else device_ms(fn)

    def fmt(ms):
        return "none" if ms is None else f"{ms:.4f} ms"

    for op, t in timings.items():
        print(f"[time] {op} at {t['shape']}, per call (device only): kernel {fmt(t['ms'])} "
              f"({fmt(t['device_ms'])}), plain {fmt(t['plain_ms'])} ({fmt(t['plain_device_ms'])}), "
              f"library {fmt(t['library_ms'])} ({fmt(t['library_device_ms'])}), "
              f"library with its own output {fmt(t.get('library_alloc_ms'))} "
              f"({fmt(t.get('library_alloc_device_ms'))}), bound {t['bound'][0]:.4f} ms ({t['bound'][1]})")
    record["timings"] = timings
    # what the CUDA-event wrapper time counts when nothing runs between the
    # two events: a floor under every "ms" above
    floor_ms = cuda_ms(lambda: None)
    print(f"[time] CUDA-event floor (nothing between the two events): {fmt(floor_ms)}")
    record["cuda_event_floor_ms"] = floor_ms
    # where a B3/B4 wrapper call's host time goes, piece by piece
    pieces = host_us(scatter_host_pieces(torch, dev, keyed_ids))
    for name, us in pieces.items():
        print(f"[host] {us:8.3f} us per call  {name}")
    record["scatter_host_pieces_us"] = pieces

    # -- 5. report -------------------------------------------------------
    sources = {"stat_scores_counts": "metrics_tpu_torch/csrc/stat_scores.cu",
               "confmat_counts": "metrics_tpu_torch/csrc/confusion_matrix.cu",
               "segment_scatter_add": "metrics_tpu_torch/csrc/segment_scatter.cu",
               "segment_scatter_max": "metrics_tpu_torch/csrc/segment_scatter.cu",
               "segment_scatter_min": "metrics_tpu_torch/csrc/segment_scatter.cu",
               "label_score_histograms": "metrics_tpu_torch/csrc/binned_counts.cu"}
    replaces = {"stat_scores_counts": "metrics_tpu/kernels/stat_scores.py:73",
                "confmat_counts": "metrics_tpu/kernels/confusion_matrix.py:45",
                "segment_scatter_add": "metrics_tpu/kernels/segment_scatter.py:93",
                "segment_scatter_max": "metrics_tpu/kernels/segment_scatter.py:227",
                "segment_scatter_min": "metrics_tpu/kernels/segment_scatter.py:227",
                "label_score_histograms": "metrics_tpu/kernels/binned_counts.py:81"}
    # launches on each kernel's own path: the ImageNet-1k collection for B1
    # and B2, the keyed collection for B3 and B4 (no ported metric has a
    # "min" leaf yet, so B4 min is held against its plain version only), the
    # sketched curve collection for B5 (the binary stream's 300 are in the
    # record); times at each path's shape
    path_launches = {**launches, **{op: keyed_launches[op] for op in scatter},
                     "label_score_histograms": curve_launches["label_score_histograms"]}
    kernels = [
        {"name": op, "route": "cuda", "source": sources[op], "replaces": replaces[op],
         "launches": path_launches[op], "max_abs_err": errors[op], "ms": timings[op]["ms"],
         "plain_ms": timings[op]["plain_ms"], "bound_ms": timings[op]["bound"][0],
         "bound_by": timings[op]["bound"][1], "library_ms": timings[op]["library_ms"],
         "library_alloc_ms": timings[op].get("library_alloc_ms"), "device_ms": timings[op]["device_ms"]}
        for op in sources
    ]
    record["kernels"] = kernels
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
        with open(args.record, "w") as fh:
            json.dump(record, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
