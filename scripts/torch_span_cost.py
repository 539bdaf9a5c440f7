#!/usr/bin/env python3
"""What the port's host spans cost, off and on, in one process.

Run from the root of a checkout::

    python3 scripts/torch_span_cost.py                  # on the card, the keyed cell's sizes
    python3 scripts/torch_span_cost.py --device cpu --tenants 100 --rows 256

1. One span (``SpanTracker.span``) and one read to the host
   (``utilities/data.py::to_host`` of a two-element tensor on the CPU, so
   that no wait for the card is timed) in a tight loop, each against the
   bare statement: with the tracker off, on, and on one level inside another
   span; nanoseconds a call, the median of five loops.
2. The keyed update of the benchmark's ``keyed_tenants.cohorts`` cell
   (``MultiTenantCollection`` of Accuracy and macro Precision/Recall/F1,
   10 classes, 10,000 tenants, 4,096-row cohorts) with the tracer on and off
   update by update, the rest of the telemetry off: each update's host time
   with no synchronize (as the benchmark's ``update`` span times it), median
   of each side, the median of the differences of the two updates of one batch
   (each batch runs on and off back to back, the side that goes first
   alternating), the host spans an update records, and the bytes a
   request's record holds in the ring.

Prints one JSON object.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def per_call_ns(fn, n: int, loops: int = 5) -> float:
    out = []
    for _ in range(loops):
        t0 = time.perf_counter_ns()
        fn(n)
        out.append((time.perf_counter_ns() - t0) / n)
    return statistics.median(out)


def span_costs(n: int) -> dict:
    import contextlib

    import torch

    from metrics_tpu_torch.observability.tracing import SpanTracker
    from metrics_tpu_torch.utilities import data

    null = contextlib.nullcontext()

    def bare(k):
        for _ in range(k):
            with null:
                pass

    def spans(tracker):
        def loop(k):
            for _ in range(k):
                with tracker.span("s"):
                    pass
        return loop

    def nested(tracker):
        def loop(k):
            with tracker.span("outer"):
                for _ in range(k):
                    with tracker.span("s"):
                        pass
        return loop

    off, on = SpanTracker(enabled=False), SpanTracker()
    t = torch.tensor([1, 2])

    def tolist(k):
        for _ in range(k):
            t.tolist()

    def to_host(k):
        for _ in range(k):
            data.to_host(t)

    saved = data.TRACER
    out = {"null_context_ns": per_call_ns(bare, n), "span_off_ns": per_call_ns(spans(off), n),
           "span_on_ns": per_call_ns(spans(on), n), "span_on_nested_ns": per_call_ns(nested(on), n),
           "tolist_ns": per_call_ns(tolist, n)}
    try:
        data.TRACER = off
        out["to_host_off_ns"] = per_call_ns(to_host, n)
        data.TRACER = on
        out["to_host_on_ns"] = per_call_ns(to_host, n)
    finally:
        data.TRACER = saved
    return out


def keyed_costs(device: str, tenants: int, rows: int, updates: int, rounds: int) -> dict:
    import tracemalloc

    import torch

    import metrics_tpu_torch as M
    from metrics_tpu_torch import observability

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(2**31 + 5)
    batches = []
    for _ in range(updates):
        ids = torch.randint(0, tenants, (rows,), generator=gen, device=dev)
        preds = torch.softmax(torch.randn(rows, 10, generator=gen, device=dev), -1)
        target = torch.randint(0, 10, (rows,), generator=gen, device=dev)
        batches.append((ids, preds, target))
    members = [M.Accuracy(device=dev)] + [cls(average="macro", num_classes=10, device=dev)
                                          for cls in (M.Precision, M.Recall, M.F1)]
    coll = M.MultiTenantCollection(members, num_tenants=tenants, validate_ids=False, device=dev)
    observability.disable()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    for b in batches:  # warm every shape
        coll.update(*b)
    coll.compute()
    sync()
    times = {False: [], True: []}
    observability.TRACER.clear()
    for r in range(rounds):
        for k, b in enumerate(batches):
            for on in ((False, True) if (k + r) % 2 else (True, False)):
                observability.TRACER.enable(on)
                t0 = time.perf_counter()
                coll.update(*b)
                times[on].append((time.perf_counter() - t0) * 1e3)
                observability.TRACER.disable()
                sync()
    requests = observability.TRACER.host_records()
    # the ring's growth over more updates, the tracer on alone
    observability.TRACER.clear()
    observability.TRACER.enable()
    coll.update(*batches[0])
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    for b in batches:
        coll.update(*b)
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    observability.TRACER.disable()
    grown = sum(d.size_diff for d in after.compare_to(before, "filename") if d.traceback[0].filename.endswith("tracing.py"))
    off_ms, on_ms = statistics.median(times[False]), statistics.median(times[True])
    paired = statistics.median(a - b for a, b in zip(times[True], times[False]))
    return {"update_off_ms": off_ms, "update_on_ms": on_ms, "on_minus_off_ms": on_ms - off_ms,
            "paired_on_minus_off_ms": paired, "updates_each": len(times[True]),
            "requests": len(requests), "host_spans_per_update": sum(r.spans for r in requests) / len(requests),
            "record_bytes": grown / len(batches)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tenants", type=int, default=10_000)
    parser.add_argument("--rows", type=int, default=4096)
    parser.add_argument("--updates", type=int, default=50)
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--loop", type=int, default=200_000)
    args = parser.parse_args(argv)
    out = {"spans": span_costs(args.loop),
           "keyed": keyed_costs(args.device, args.tenants, args.rows, args.updates, args.rounds)}
    if args.device == "cuda":
        import subprocess

        out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
