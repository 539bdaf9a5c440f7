"""Device-time attribution for the compiled dispatch sites.

Counterpart of ``metrics_tpu/observability/profiling.py``.
``dispatch_seconds`` measures the HOST time of a compiled dispatch: submit
only, because a CUDA graph replay returns once enqueued. That histogram
cannot say where a slow ingest goes — host-side queueing (Python, the
donation audit, the signature lookup) or the card's own execution — and the
two have different fixes. This module splits them without touching any
compiled program:

* :func:`set_profiling` arms an opt-in **sampled** mode: every Nth dispatch
  per path pays the measurement, every other dispatch pays one counter
  increment. A sampled dispatch on the card first waits for the current
  stream (the JAX package's ``block_until_ready`` on the state, the one
  deliberate synchronizing call of a sample), records a CUDA event, stamps
  the host clock, submits, then records a second event and waits for it:

  - ``host_queue_s = submit_return - submit_start`` on the host clock;
  - ``device_dispatch_s`` = the time between the two events, on the card's
    clock: the device window of the submit, never the host clock.

  On the CPU there is no stream: the work runs inside the submit, and the
  device half is the host time from the submit's return to the sample's end.
  Both feed the log2 histogram series ``dispatch_host_queue_seconds{path=}``
  and ``dispatch_device_seconds{path=}`` beside ``dispatch_seconds``, and
  (with the event log on) paired ``profile`` timeline slices.
* :func:`profile_report` adds the per-path sample tallies, the split
  percentiles and the per-program cost entries, which read
  :mod:`~metrics_tpu_torch.observability.cost` (no XLA cost analysis here).

Disarmed (the default) :meth:`Profiler.begin` is one attribute read
returning ``None``: no lock, no counter, no event.
"""
import math
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.histogram import HISTOGRAMS, _series_key

__all__ = [
    "DISPATCH_DEVICE_SECONDS",
    "DISPATCH_HOST_QUEUE_SECONDS",
    "PROFILER",
    "Profiler",
    "get_profiling",
    "profile_report",
    "set_profiling",
    "summary",
]

#: the split-latency series (beside histogram.DISPATCH_SECONDS)
DISPATCH_HOST_QUEUE_SECONDS = "dispatch_host_queue_seconds"
DISPATCH_DEVICE_SECONDS = "dispatch_device_seconds"

#: the dispatch paths the library instruments
DISPATCH_PATHS = ("compiled", "update_many", "keyed_scatter", "serving_flush", "serving_stage")


class _Sample:
    """One sampled dispatch in progress: its path, host start, and on the
    card the stream and the start event of its device window."""

    __slots__ = ("path", "t0", "stream", "start")

    def __init__(self, path: str, t0: float, stream: Optional[Any]) -> None:
        self.path, self.t0, self.stream, self.start = path, t0, stream, None
        self.mark_device_start()

    def mark_device_start(self) -> None:
        """Open (or re-open) the device window at this point of the stream."""
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)


class Profiler:
    """Sampled host-queue/device-time splitter (one process-global instance,
    :data:`PROFILER`).

    Call sites bracket each compiled dispatch with :meth:`begin`/:meth:`finish`;
    when disarmed (``sample_every`` = 0) ``begin`` is a single attribute read
    returning ``None``. Armed, every dispatch increments a per-path counter
    and every ``sample_every``-th one (the 1st, the N+1th, ...) pays the
    measured split. Nested sites (a serving flush driving a keyed update)
    suppress the inner sample through a thread-local guard.
    """

    def __init__(self) -> None:
        self.sample_every = 0
        self._lock = threading.Lock()
        self._active = threading.local()
        self._dispatches: Dict[str, int] = {}
        self._samples: Dict[str, int] = {}
        #: (telemetry_key, path) -> weakref to the CompiledDispatch a
        #: sampled call went through
        self._dispatch_refs: Dict[Tuple[str, str], Any] = {}
        self._touched = False

    # -- arming --------------------------------------------------------------

    def set_sample_every(self, sample_every: Optional[int]) -> None:
        if sample_every is not None and int(sample_every) < 0:
            raise ValueError(f"sample_every must be >= 1 (or None/0 to disarm), got {sample_every}")
        with self._lock:
            self.sample_every = int(sample_every or 0)
            if self.sample_every:
                self._touched = True

    # -- the dispatch bracket ------------------------------------------------

    def begin(self, path: str, device: Optional[torch.device] = None, stream: Optional[Any] = None
              ) -> Optional[_Sample]:
        """Open a dispatch bracket; ``None`` unless this dispatch is sampled.
        ``device`` is where the dispatch runs: on a CUDA device the bracket
        waits for ``stream`` (default: the current stream) first, so the
        submit starts against an idle card, and times the device window with
        events on that stream."""
        n = self.sample_every
        if n <= 0:
            return None
        if getattr(self._active, "depth", 0):
            return None  # nested site: the outer bracket owns this dispatch
        with self._lock:
            self._touched = True
            count = self._dispatches.get(path, 0)
            self._dispatches[path] = count + 1
            fire = count % n == 0
            if fire:
                self._samples[path] = self._samples.get(path, 0) + 1
        if not fire:
            return None
        self._active.depth = 1
        if device is not None and torch.device(device).type == "cuda":
            stream = stream if stream is not None else torch.cuda.current_stream(device)
            stream.synchronize()  # the sample's deliberate wait
        else:
            stream = None
        return _Sample(path, time.perf_counter(), stream)

    def finish(
        self,
        token: _Sample,
        key: Optional[str] = None,
        dispatch: Any = None,
        submit_end: Optional[float] = None,
    ) -> None:
        """Close a sampled bracket and record the split. ``submit_end`` is
        the host clock right after the submit returned (callers that stamp it
        for ``dispatch_seconds`` pass it, so both views agree); ``dispatch``
        is the :class:`~metrics_tpu_torch.utilities.aot.CompiledDispatch`
        the sample went through."""
        try:
            t1 = submit_end if submit_end is not None else time.perf_counter()
            if token.stream is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(token.stream)
                end.synchronize()
                device_s = token.start.elapsed_time(end) / 1e3
            else:
                device_s = time.perf_counter() - t1
        finally:
            self._active.depth = 0
        path = token.path
        host_queue_s = max(0.0, t1 - token.t0)
        device_s = max(0.0, device_s)
        HISTOGRAMS.observe(DISPATCH_HOST_QUEUE_SECONDS, host_queue_s, unit="s", path=path)
        HISTOGRAMS.observe(DISPATCH_DEVICE_SECONDS, device_s, unit="s", path=path)
        if dispatch is not None and key is not None:
            ref = weakref.ref(dispatch)
            with self._lock:
                self._dispatch_refs[(key, path)] = ref
        if EVENTS.enabled:
            EVENTS.record("profile", key, dur_s=host_queue_s, t_start=token.t0, path=path, phase="host_queue")
            EVENTS.record("profile", key, dur_s=device_s, t_start=t1, path=path, phase="device")

    # -- export --------------------------------------------------------------

    def _split_percentiles(self) -> Dict[str, Dict[str, Any]]:
        """p50/p99 of both split series per path, from the live histograms."""
        out: Dict[str, Dict[str, Any]] = {}
        for series_name, field in ((DISPATCH_HOST_QUEUE_SECONDS, "host_queue"),
                                   (DISPATCH_DEVICE_SECONDS, "device_dispatch")):
            for _, hist, labels, name in HISTOGRAMS.series_items():
                if name != series_name:
                    continue
                entry = out.setdefault(labels.get("path", ""), {})
                entry[field] = {"count": hist.count, "p50_s": hist.percentile(50.0), "p99_s": hist.percentile(99.0)}
        return out

    def _executable_costs(self) -> Dict[str, Dict[str, Any]]:
        from metrics_tpu_torch.observability.cost import executable_cost

        with self._lock:
            refs = dict(self._dispatch_refs)
        out: Dict[str, Dict[str, Any]] = {}
        for (key, path), ref in sorted(refs.items()):
            fn = ref()
            if fn is None:
                continue  # the dispatch (and its graphs) were collected
            programs: List[Dict[str, Any]] = [executable_cost(entry) for entry in getattr(fn, "_cache", {}).values()]
            available = [p for p in programs if p.get("available")]
            entry: Dict[str, Any] = {"path": path, "programs": len(programs), "available": bool(available)}
            for field in ("flops", "bytes_accessed", "output_bytes"):
                values = [p[field] for p in available if p.get(field) is not None]
                if values:
                    total = float(sum(values))
                    entry[field] = int(total) if not math.isnan(total) else None
            out[f"{key}:{path}"] = entry
        return out

    def report(self) -> Dict[str, Any]:
        """Sample tallies, split-latency percentiles per path, and the cost
        entry of every live sampled program."""
        with self._lock:
            dispatches = dict(self._dispatches)
            samples = dict(self._samples)
            sample_every = self.sample_every
        return {
            "sample_every": sample_every,
            "enabled": sample_every > 0,
            "dispatches": dispatches,
            "samples": samples,
            "paths": self._split_percentiles(),
            "executables": self._executable_costs(),
        }

    def summary(self) -> Dict[str, Any]:
        """The ``snapshot()["profiling"]`` section: ``{}`` until armed or
        sampled, flat tallies after."""
        with self._lock:
            if not self._touched:
                return {}
            return {
                "enabled": self.sample_every > 0,
                "sample_every": self.sample_every,
                "dispatches": dict(self._dispatches),
                "samples": dict(self._samples),
            }

    # -- lifecycle -----------------------------------------------------------

    def disable(self) -> None:
        """Stop sampling (``observability.disable()``)."""
        with self._lock:
            self.sample_every = 0

    def reset(self) -> None:
        """Clear tallies and program refs; the stride survives."""
        with self._lock:
            self._dispatches.clear()
            self._samples.clear()
            self._dispatch_refs.clear()
            self._touched = self.sample_every > 0


#: the process-global dispatch profiler
PROFILER = Profiler()


def set_profiling(sample_every: Optional[int] = None) -> None:
    """Arm sampled dispatch profiling: every ``sample_every``-th compiled
    dispatch per path pays the host-queue/device-time split (exactly
    ``ceil(steps / N)`` samples over ``steps`` dispatches); ``None``/``0``
    disarms."""
    PROFILER.set_sample_every(sample_every)


def get_profiling() -> int:
    """The current sampling stride (0 = disarmed)."""
    return PROFILER.sample_every


def profile_report() -> Dict[str, Any]:
    """The profiling plane's full report — see :meth:`Profiler.report`."""
    return PROFILER.report()


def summary() -> Dict[str, Any]:
    """The profiling snapshot section (``{}`` until armed or sampled)."""
    return PROFILER.summary()


def split_series_keys(path: str) -> Tuple[str, str]:
    """The histogram registry keys of the two split series for ``path``."""
    return (
        _series_key(DISPATCH_HOST_QUEUE_SECONDS, {"path": path}),
        _series_key(DISPATCH_DEVICE_SECONDS, {"path": path}),
    )
