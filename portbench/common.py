"""What every driver of the benchmark shares.

Finding a cell by name in ``BENCHMARK.json`` and the files that belong to
it; the check for cards; the benchmark's own spans around the calls into
each layer of the program; the profiler's sub-window and its reduction to
device time, idle share and a breakdown; the device record; and the result
line with the numbers that decided ``correct``.

Nothing here imports the program or the JAX package: a driver imports the
program itself, inside its run.
"""
import contextlib
import heapq
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: the root of the checkout (the folder that holds ``BENCHMARK.json``)
ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
#: top-level module names that no run may load: the JAX package and JAX
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "metrics_tpu")
#: the card's published HBM bandwidth (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
#: prefix of the benchmark's own profiler ranges
SPAN_PREFIX = "portbench."
#: parts of the names of the program's own CUDA kernels (``csrc/*.cu``), to
#: count their records in a trace against the program's launch counters
PORT_KERNEL_NAMES = ("confmat_", "stat_scores_counts", "hist_", "scatter_kernel", "extremal")


class BenchmarkError(RuntimeError):
    """A run that cannot give a result: it exits non-zero and prints none."""


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


def set_cache_dirs() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(ROOT / "build" / "torchinductor")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> Any:
    """Import the file ``path`` as a module named ``name`` (names may hold dots)."""
    if not path.is_file():
        raise BenchmarkError(f"{path.relative_to(ROOT)} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything found by its names."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    def builder(self) -> Any:
        return load_module(HERE / "configs" / f"{self.config_name}.py", f"portbench_config_{self.config_name}")

    def reference(self) -> Any:
        return load_module(HERE / "reference" / f"{self.config_name}.py", f"portbench_reference_{self.config_name}")

    def driver(self) -> Any:
        return load_module(HERE / "drivers" / f"{self.traffic['driver']}.py", f"portbench_driver_{self.traffic['driver']}")


def _reports(metric: Dict[str, Any], cell: str, reported: Sequence[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def find_cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` and its files."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchmarkError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(ROOT / config["file"])
    traffic = load_json(HERE / "traffic" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), w["config"], w["traffic"], cfg, traffic, e2e, per_layer)


def require_cards(count: int) -> None:
    """Stop, with no result, unless ``count`` CUDA cards are here."""
    import torch

    if not torch.cuda.is_available():
        raise BenchmarkError("torch.cuda.is_available() is false: this benchmark runs on CUDA cards only")
    if torch.cuda.device_count() < count:
        raise BenchmarkError(f"the cell asks for {count} cards and {torch.cuda.device_count()} are here")


def quiet_host() -> None:
    """Steady the host side before a window: one collection of the objects
    that set-up made, which then leave the collector's generations."""
    import gc

    gc.collect()
    gc.freeze()


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------


class Spans:
    """The benchmark's own spans around calls into the program's layers.

    Off (``--trace 0``), ``span(name)`` is one shared null context. On, it
    opens a ``torch.profiler.record_function`` range ``portbench.<name>``
    (which the profiler's sub-window records with the device work launched
    inside it) and keeps the range's host duration on the host clock."""

    def __init__(self, on: bool) -> None:
        self.on = on
        #: off while the profiler runs: its ranges are still opened, not counted
        self.counting = True
        self.seconds: Dict[str, List[float]] = {}
        self._null = contextlib.nullcontext()

    def span(self, name: str):
        return self._span(name) if self.on else self._null

    @contextlib.contextmanager
    def _span(self, name: str):
        import torch

        with torch.profiler.record_function(SPAN_PREFIX + name):
            start = time.perf_counter()
            try:
                yield
            finally:
                if self.counting:
                    self.seconds.setdefault(name, []).append(time.perf_counter() - start)


# --------------------------------------------------------------------------
# the profiler's sub-window
# --------------------------------------------------------------------------


@dataclass
class TraceData:
    """What the profiler saw in its sub-window (microseconds; the records'
    times are on the trace's own clock)."""

    window_us: float
    busy_us: float
    device_ops: List[Tuple[str, float, float]]
    host_ranges: List[Tuple[str, float, float]]
    #: per benchmark span name: the device time of each instance's launches
    span_device_us: Dict[str, List[float]] = field(default_factory=dict)
    #: per benchmark span name: the device records under its instances
    span_records: Dict[str, int] = field(default_factory=dict)
    #: records of the program's own kernels (against its launch counters)
    port_records: int = 0

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_us / self.window_us


def merge_intervals(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as disjoint sorted intervals."""
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def reduce_profile(prof: Any, window_us: float) -> TraceData:
    """The sub-window's device records, the benchmark's host ranges and the
    device time launched under each, from a finished ``torch.profiler``;
    ``window_us`` is the sub-window's length on the host clock, between the
    synchronizations that open and close it."""
    from torch.autograd import DeviceType

    device, host = [], []
    span_device_us: Dict[str, List[float]] = {}
    span_records: Dict[str, int] = {}
    for e in prof.events():
        if e.name.startswith(SPAN_PREFIX):
            if e.device_type == DeviceType.CPU:
                name = e.name[len(SPAN_PREFIX):]
                host.append((name, e.time_range.start, e.time_range.end))
                span_device_us.setdefault(name, []).append(float(e.device_time_total))
                span_records[name] = span_records.get(name, 0) + _kernels_under(e)
            continue
        if e.device_type != DeviceType.CPU and not getattr(e, "is_user_annotation", False):
            device.append((e.name, e.time_range.start, e.time_range.end))
    busy = sum(b - a for a, b in merge_intervals([(a, b) for _, a, b in device]))
    port = sum(1 for name, _, _ in device if "at::native" not in name and any(k in name for k in PORT_KERNEL_NAMES))
    return TraceData(window_us, busy, device, host, span_device_us, span_records, port)


def _kernels_under(event: Any) -> int:
    stack, n = [event], 0
    while stack:
        e = stack.pop()
        n += len(e.kernels)
        stack.extend(e.cpu_children)
    return n


def breakdown(trace: TraceData, top: int = 10) -> Dict[str, List[List[Any]]]:
    """The device operations that took most time, and the idle gaps of the
    device summed by which benchmark spans the host was inside."""
    by_op: Dict[str, float] = {}
    for name, a, b in trace.device_ops:
        key = name[:96]
        by_op[key] = by_op.get(key, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    merged = merge_intervals([(a, b) for _, a, b in trace.device_ops])
    if not merged:
        return {"device_ops": [], "idle_gaps": []}
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps = [(a, b) for a, b in gaps if b > a]
    by_host: Dict[str, float] = {}
    ranges = sorted((a, b, n) for n, a, b in trace.host_ranges)
    active: List[Tuple[float, str]] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(ranges) and ranges[i][0] <= mid:
            heapq.heappush(active, (ranges[i][1], ranges[i][2]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        key = "+".join(sorted({n for _, n in active})) or "outside the benchmark's spans"
        by_host[key] = by_host.get(key, 0.0) + (b - a)
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {
        "device_ops": [[k, v / 1e6] for k, v in ops],
        "idle_gaps": [[k, v / 1e6] for k, v in idle],
    }


class Profiled:
    """The profiler over a short steady sub-window of the traced run.

    ``start()`` opens ``torch.profiler`` (host and device activities),
    synchronizes the cards and stamps the host clock;
    ``stop()`` synchronizes again, stamps the clock and closes the profiler;
    ``finish()``, called once the run's window has closed, reduces the trace
    (reading a trace takes seconds, which the window must not hold). The
    sub-window's length is the host time between the two stamps. Off, all
    three do nothing."""

    def __init__(self, on: bool, devices: Sequence[Any]) -> None:
        self.on = on
        self.devices = list(devices)
        self.data: Optional[TraceData] = None
        self._prof = None
        self._closed = None
        self._t0 = 0.0
        self._window_us = 0.0
        self.launches_before: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}

    def _profile(self) -> Any:
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.devices else []))

    def prime(self) -> None:
        """Open and close one empty profile, in set-up: the profiler's first
        start in a process takes seconds (its tracing back ends start), which
        must not fall inside the window."""
        if not self.on:
            return
        import torch

        with self._profile():
            for d in self.devices:
                torch.cuda.synchronize(d)

    def start(self) -> None:
        if not self.on or self._prof is not None or self._closed is not None or self.data is not None:
            return
        import torch

        self._prof = self._profile()
        self._prof.__enter__()
        for d in self.devices:
            torch.cuda.synchronize(d)
        self.launches_before = _launches()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        for d in self.devices:
            torch.cuda.synchronize(d)
        self._window_us = (time.perf_counter() - self._t0) * 1e6
        after = _launches()
        self._prof.__exit__(None, None, None)
        self.launches = {k: v - self.launches_before.get(k, 0) for k, v in after.items()}
        self._closed, self._prof = self._prof, None

    def finish(self) -> Optional[TraceData]:
        self.stop()
        if self._closed is not None and self.data is None:
            self.data = reduce_profile(self._closed, self._window_us)
            self._closed = None
        return self.data


def _launches() -> Dict[str, int]:
    """The port's kernel launch counters (``kernels/_common.py``)."""
    from metrics_tpu_torch.kernels import _common

    return {op: paths.get("cuda", 0) for op, paths in _common.dispatch_summary()["dispatch"].items()}


# --------------------------------------------------------------------------
# the record of a run and the result line
# --------------------------------------------------------------------------


@dataclass
class RunRecord:
    """What a driver hands the per-layer readers and the result line."""

    cell: Cell
    end_to_end: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    #: the profiler's sub-window, one a card
    traces: List[TraceData] = field(default_factory=list)
    #: the program's own counters and histograms, read at the window's close
    counters: Dict[str, Any] = field(default_factory=dict)
    #: the driver's own readings (bytes handed to each update, generator lag)
    extras: Dict[str, Any] = field(default_factory=dict)
    #: ``{name: (value, limit)}``: the numbers that decided ``correct``
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    device: Dict[str, Any] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            isinstance(v, (int, float)) and not math.isnan(v) and v <= limit for v, limit in self.checks.values()
        )


def read_layers(record: RunRecord) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric of the cell, by its reader ``layers/<name>.py``;
    a reader that finds nothing to read returns ``None`` and its metric is
    left out."""
    out = {}
    for metric in record.cell.per_layer:
        reader = load_module(HERE / "layers" / f"{metric['name']}.py", f"portbench_layer_{metric['name']}")
        value = reader.read(record)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


def device_record(torch: Any, count: int, trace: Optional[Sequence[TraceData]] = None) -> Dict[str, Any]:
    """The ``device`` object of the result line."""
    peak_bytes = max(torch.cuda.max_memory_allocated(d) for d in range(count))
    out = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": int(peak_bytes),
    }
    if trace:
        out["busy_s"] = sum(t.busy_us for t in trace) / len(trace) / 1e6
        out["window_s"] = sum(t.window_us for t in trace) / len(trace) / 1e6
    return out


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip())
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable ({type(err).__name__})"


def result_line(record: RunRecord, trace_on: bool, breakdown_data: Optional[Dict[str, Any]] = None) -> str:
    """The last line of standard output: one JSON object."""
    metrics = read_layers(record) if trace_on else {
        m["name"]: {"value": float(record.end_to_end[m["name"]]), "unit": m["unit"]}
        for m in record.cell.end_to_end if m["name"] in record.end_to_end
    }
    line = {
        "correct": record.correct,
        "attempted": int(record.attempted),
        "failed": int(record.failed),
        "metrics": metrics,
        "device": record.device,
    }
    if trace_on and breakdown_data is not None:
        line["breakdown"] = breakdown_data
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in record.checks.items()}
    return json.dumps(line)


def print_checks(record: RunRecord) -> None:
    """Each compared number beside its limit, as the last lines on standard error."""
    for name, (value, limit) in record.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()


def spread_note(ends: Sequence[float], t0: float) -> str:
    """How steady a closed loop's epochs were: their median and extremes."""
    import numpy as np

    if not ends:
        return "no epoch"
    d = np.diff(np.concatenate([[t0], np.asarray(ends)])) * 1e3
    return (f"epoch ms p10 {np.percentile(d, 10):.2f} p50 {np.percentile(d, 50):.2f} "
            f"p90 {np.percentile(d, 90):.2f} max {d.max():.2f}")


def emit(record: RunRecord, trace_on: bool, breakdown_data: Optional[Dict[str, Any]] = None) -> int:
    """Print the checks and the result line, after the JAX guard; the exit code."""
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}, which no run may load; no result", file=sys.stderr)
        return 3
    for note in record.notes:
        print(note, file=sys.stderr)
    line = result_line(record, trace_on, breakdown_data)
    print_checks(record)
    print(line)
    sys.stdout.flush()
    return 0
