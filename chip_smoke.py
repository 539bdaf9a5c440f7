#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. Print the card (``nvidia-smi`` name and power limit), the PyTorch and CUDA
   versions; build the CUDA kernels from ``metrics_tpu_torch/csrc`` with
   ``nvcc`` and print the build time and the compiler's resource report.
2. Hold each kernel against its plain PyTorch version on the same CUDA
   tensors, at the main-path shape and at ragged ones: exact equality.
3. The main path: ImageNet-1k evaluation (1000 classes, the 50,000-image
   validation split in batches of 1024 float32 softmax rows, 49 ``forward``
   calls, then ``compute()``) through
   ``MetricCollection({Accuracy, macro Precision/Recall/F1, ConfusionMatrix})``
   on the card. Each kernel must have launched exactly once per batch, and
   the results must equal the same collection run on the CPU over the same
   batches (counts exactly, float metrics within 1e-6).
   The per-``forward`` time of the collection, and under the profiler the
   device's busy share of ten forwards with the kernels that fill it.
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
    launches = {op: _common.launch_count(op) for op in errors}
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
               "confmat_counts": "metrics_tpu_torch/csrc/confusion_matrix.cu"}
    replaces = {"stat_scores_counts": "metrics_tpu/kernels/stat_scores.py:73",
                "confmat_counts": "metrics_tpu/kernels/confusion_matrix.py:45"}
    kernels = [
        {"name": op, "route": "cuda", "source": sources[op], "replaces": replaces[op],
         "launches": launches[op], "max_abs_err": errors[op], "ms": timings[op]["ms"],
         "plain_ms": timings[op]["plain_ms"], "bound_ms": timings[op]["bound"][0],
         "bound_by": timings[op]["bound"][1], "library_ms": timings[op]["library_ms"],
         "device_ms": timings[op]["device_ms"]}
        for op in ("stat_scores_counts", "confmat_counts")
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
