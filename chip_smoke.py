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
4. Times at the main-path shapes: the median of 50 CUDA-event-timed calls
   of each kernel's wrapper, of its plain version and of the one PyTorch
   call that computes the same function (where there is one), each beside
   the least time the card could take; and the same calls' device time
   alone (kernels and memsets, by the profiler), which leaves out the
   host's launch cost.
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


def scatter_inputs(torch, gen, dev, r, s, d, floats=False):
    """Rows (integer-valued, or normal floats) and ids uniform in [0, s) with
    -1, s and s+7 mixed in."""
    if floats:
        rows = torch.randn((r, d), generator=gen, device=dev)
    else:
        rows = torch.randint(-2, 3, (r, d), generator=gen, device=dev).float()
    ids = torch.randint(0, s, (r,), generator=gen, device=dev)
    ids[0::97], ids[1::97], ids[2::97] = -1, s, s + 7
    return rows, ids


def special_rows(torch, dev):
    """NaN, signed zeros and infinities, routed so each case has a segment."""
    nan, inf = float("nan"), float("inf")
    cases = [(nan, 0), (1.0, 0), (2.0, 1), (nan, 1), (-0.0, 2), (0.0, 2), (0.0, 3), (-0.0, 3), (-0.0, 4),
             (0.0, 5), (inf, 6), (1.0, 6), (-inf, 7), (-1.0, 7), (inf, 8), (-inf, 8), (5.0, -1), (5.0, 12)]
    rows = torch.tensor([[v, -v] for v, _ in cases], device=dev)
    ids = torch.tensor([sid for _, sid in cases], device=dev)
    return rows, ids, 12  # segments 9..11 get no row


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
    from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_cuda, confmat_counts_torch
    from metrics_tpu_torch.kernels.segment_scatter import (
        segment_scatter_add_cuda,
        segment_scatter_add_torch,
        segment_scatter_max_cuda,
        segment_scatter_max_torch,
        segment_scatter_min_cuda,
        segment_scatter_min_torch,
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
    scatter_cases = [(KEYED_ROWS, KEYED_TENANTS, 40), (KEYED_ROWS, KEYED_TENANTS, 6), (KEYED_ROWS, KEYED_TENANTS, 1),
                     (1, 1, 1), (4099, 100_000, 3), (300, 64, 16)]
    for op, (kernel, plain) in scatter.items():
        errors[op] = 0.0
        for r, s, d in scatter_cases:
            rows, ids = scatter_inputs(torch, gen, dev, r, s, d)
            got = kernel(rows, ids, s, device=dev)
            torch.cuda.synchronize()
            want = plain(rows, ids, s)
            ok = all(same_bits(g, w) for g, w in zip(got, want))
            parity.append({"kernel": op, "shape": [r, s, d], "rows": "integer-valued", "equal": ok})
            print(f"[parity] {op} R={r} S={s} D={d} integer-valued rows, invalid ids: "
                  f"{'equal' if ok else 'DIFFERENT'}")
            if not ok:
                fail(f"{op} differs from its plain version at R={r}, S={s}, D={d}")
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
        if kernel_op == "segment_scatter_add":
            library = (lambda buffer=buffer, rows=rows: buffer.index_add_(0, safe, rows))
        else:
            index = safe.unsqueeze(1).expand(-1, d).contiguous()
            how = "amax" if kernel_op.endswith("max") else "amin"
            library = (lambda buffer=buffer, index=index, rows=rows, how=how:
                       buffer.scatter_reduce_(0, index, rows, how, include_self=True))
        nbytes = KEYED_ROWS * d * 4 + KEYED_ROWS * 8 + s_ * d * 4 + s_ * 4
        calls[op] = {
            "ms": lambda kernel=kernel, rows=rows: kernel(rows, keyed_ids, s_, device=dev),
            "plain_ms": lambda plain=plain, rows=rows: plain(rows, keyed_ids, s_),
            "library_ms": library,
        }
        timings[op] = {"bound": bound(nbytes, KEYED_ROWS * d), "shape": f"rows ({KEYED_ROWS}, {d}) float32, ids "
                       f"({KEYED_ROWS},) int64, S={s_}"}
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
              f"bound {t['bound'][0]:.4f} ms ({t['bound'][1]})")
    record["timings"] = timings

    # -- 5. report -------------------------------------------------------
    sources = {"stat_scores_counts": "metrics_tpu_torch/csrc/stat_scores.cu",
               "confmat_counts": "metrics_tpu_torch/csrc/confusion_matrix.cu",
               "segment_scatter_add": "metrics_tpu_torch/csrc/segment_scatter.cu",
               "segment_scatter_max": "metrics_tpu_torch/csrc/segment_scatter.cu",
               "segment_scatter_min": "metrics_tpu_torch/csrc/segment_scatter.cu"}
    replaces = {"stat_scores_counts": "metrics_tpu/kernels/stat_scores.py:73",
                "confmat_counts": "metrics_tpu/kernels/confusion_matrix.py:45",
                "segment_scatter_add": "metrics_tpu/kernels/segment_scatter.py:93",
                "segment_scatter_max": "metrics_tpu/kernels/segment_scatter.py:227",
                "segment_scatter_min": "metrics_tpu/kernels/segment_scatter.py:227"}
    # launches on each kernel's own path: the ImageNet-1k collection for B1
    # and B2, the keyed collection for B3 and B4 (no ported metric has a
    # "min" leaf yet, so B4 min is held against its plain version only)
    path_launches = {**launches, **{op: keyed_launches[op] for op in scatter}}
    kernels = [
        {"name": op, "route": "cuda", "source": sources[op], "replaces": replaces[op],
         "launches": path_launches[op], "max_abs_err": errors[op], "ms": timings[op]["ms"],
         "plain_ms": timings[op]["plain_ms"], "bound_ms": timings[op]["bound"][0],
         "bound_by": timings[op]["bound"][1], "library_ms": timings[op]["library_ms"],
         "device_ms": timings[op]["device_ms"]}
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
