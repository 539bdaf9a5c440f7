"""Runtime telemetry of the port: one snapshot of every observability plane.

Counterpart of ``metrics_tpu/observability/__init__.py``:

* :mod:`~metrics_tpu_torch.observability.registry` — thread-safe
  per-metric counters (update/forward/compute/reset, keyed rows, invalid
  tenant ids, sketch merges) and wall-time histograms, plus sync stats;
* :mod:`~metrics_tpu_torch.observability.retrace` — per-metric CUDA graph
  capture counts with a warning past a threshold (:data:`MONITOR`);
* :mod:`~metrics_tpu_torch.observability.cost` — state byte counts; the
  compiler cost reports, which a CUDA graph has none of, say so;
* :mod:`~metrics_tpu_torch.observability.events` — the bounded,
  step-correlated event log (:data:`EVENTS`, :func:`set_step`,
  :func:`step_context`);
* :mod:`~metrics_tpu_torch.observability.timeline` — Chrome-trace/Perfetto
  JSON of the event log, one process or the whole fleet;
* :mod:`~metrics_tpu_torch.observability.health` — NaN/Inf/zero-weight
  monitoring: ``Metric.check_health()`` and the opt-in per-update guard
  (:func:`set_health_policy`), whose compiled form reads no value on the
  dispatch's path;
* :mod:`~metrics_tpu_torch.observability.histogram` — fixed-bucket log2
  histograms (:data:`HISTOGRAMS`: dispatch times, sync round trips, gather
  payload sizes) with windowed views;
* :mod:`~metrics_tpu_torch.observability.aggregate` — mergeable snapshots
  and :func:`aggregate_snapshots` over ``gather_all_pytrees``;
* :mod:`~metrics_tpu_torch.observability.tracing` — collective spans with
  deterministic ids (:data:`TRACER`), the clock handshake, the fleet merge
  and straggler diagnostics;
* :mod:`~metrics_tpu_torch.observability.slo` — SLO burn rates over the
  windowed histograms (:data:`SLO_REGISTRY`) and the tick-driven
  :data:`WATCHDOG`;
* :mod:`~metrics_tpu_torch.observability.profiling` — sampled host-queue /
  device-time split of the compiled dispatches (:func:`set_profiling`), the
  device window timed by CUDA events;
* :mod:`~metrics_tpu_torch.observability.memory` — the state-byte ledger
  (:data:`LEDGER`), :func:`memory_report` and :func:`on_pressure`
  watermarks;
* :mod:`~metrics_tpu_torch.observability.export` — :func:`snapshot` (a
  JSON-serializable dict) and :func:`render_prometheus`.

Telemetry is on by default, as in the JAX package; the health guard
(policy ``"off"``) and the profiler (disarmed) are off. Every call site
gates on a lock-free read and records host-side facts only: no
instrumented path reads a tensor to the host or synchronizes the card
unless the health policy is armed on an eager path or a profiled dispatch
is sampled, so its times are host times (the time to enqueue work on the
card). The kernels' dispatch counters (``snapshot()["kernels"]``) count
whether telemetry is on or off. Typical scrape::

    from metrics_tpu_torch import observability
    snap = observability.snapshot()           # JSON-serializable dict
    text = observability.render_prometheus()  # Prometheus text format
    observability.timeline.export("metrics-timeline.json")
"""
from metrics_tpu_torch.observability import timeline, tracing  # noqa: F401
from metrics_tpu_torch.observability.aggregate import (  # noqa: F401
    aggregate_snapshots,
    apply_pytree,
    merge_snapshots,
    snapshot_pytree,
)
from metrics_tpu_torch.observability.cost import program_cost, pytree_nbytes  # noqa: F401
from metrics_tpu_torch.observability.events import (  # noqa: F401
    EVENT_KINDS,
    EVENTS,
    Event,
    EventLog,
    get_step,
    set_step,
    step_context,
)
from metrics_tpu_torch.observability.export import dumps, render_prometheus, snapshot  # noqa: F401
from metrics_tpu_torch.observability.health import (  # noqa: F401
    HEALTH,
    HealthMonitor,
    MetricHealthError,
    get_health_policy,
    set_health_policy,
)
from metrics_tpu_torch.observability.histogram import (  # noqa: F401
    HISTOGRAMS,
    HistogramRegistry,
    HistogramWindow,
    Log2Histogram,
)
from metrics_tpu_torch.observability.registry import TELEMETRY, TelemetryRegistry  # noqa: F401
from metrics_tpu_torch.observability.memory import (  # noqa: F401
    LEDGER,
    MemoryLedger,
    PressureHandle,
    bundle_bytes,
    memory_report,
    on_pressure,
)
from metrics_tpu_torch.observability.profiling import (  # noqa: F401
    PROFILER,
    Profiler,
    get_profiling,
    profile_report,
    set_profiling,
)
from metrics_tpu_torch.observability.retrace import (  # noqa: F401
    MONITOR,
    RetraceMonitor,
    arg_signature,
    get_retrace_threshold,
    set_retrace_threshold,
)
from metrics_tpu_torch.observability.slo import SLO, SLO_REGISTRY, WATCHDOG, SLORegistry, SLOWatchdog, burn_rate  # noqa: F401
from metrics_tpu_torch.observability.tracing import (  # noqa: F401
    TRACER,
    CollectiveSpan,
    SpanTracker,
    degraded_processes,
    estimate_clock_offsets,
    straggler_report,
)


def enable(on: bool = True) -> None:
    """Turn telemetry, event recording AND collective-span tracing on (the
    default) or off process-wide. The health guard is governed separately by
    :func:`set_health_policy` (default ``"off"``)."""
    TELEMETRY.enable(on)
    EVENTS.enable(on)
    TRACER.enable(on)


def disable() -> None:
    """Stop recording; instrumented call sites reduce to attribute reads.
    The dispatch profiler disarms and the memory ledger drops its pending
    watermark callbacks."""
    TELEMETRY.disable()
    EVENTS.disable()
    TRACER.disable()
    PROFILER.disable()
    LEDGER.disable()


def reset() -> None:
    """Clear all recorded counters, timers, sync stats, retrace ledgers,
    events, histograms (window rings included), collective spans, SLO
    declarations and watchdog state, profiling tallies, memory-ledger
    high-waters and watermarks, health records, and the async engine's,
    serving, durability and resilience planes' counters; enablement, the health
    policy, the step tag, the profiler's stride, the ledger's tracked owners
    and the kernels' dispatch counters survive. Span-id sequence counters
    and async generations reset too — like any collective, reset on every
    process together or on none."""
    import sys

    TELEMETRY.reset()
    MONITOR.reset()
    EVENTS.clear()
    HEALTH.reset()
    HISTOGRAMS.reset()
    TRACER.clear()
    SLO_REGISTRY.reset()
    WATCHDOG.reset()
    PROFILER.reset()
    LEDGER.reset()
    async_sync = sys.modules.get("metrics_tpu_torch.utilities.async_sync")
    if async_sync is not None and async_sync._ENGINE is not None:
        async_sync._ENGINE.reset()
    serving = sys.modules.get("metrics_tpu_torch.serving.telemetry")
    if serving is not None:
        serving.SERVING_STATS.reset()
    durability = sys.modules.get("metrics_tpu_torch.durability.telemetry")
    if durability is not None:
        durability.DURABILITY_STATS.reset()
    resilience = sys.modules.get("metrics_tpu_torch.resilience.telemetry")
    if resilience is not None:
        resilience.RESILIENCE_STATS.reset()


__all__ = [
    "CollectiveSpan",
    "EVENTS",
    "EVENT_KINDS",
    "Event",
    "EventLog",
    "HEALTH",
    "HISTOGRAMS",
    "HealthMonitor",
    "HistogramRegistry",
    "HistogramWindow",
    "LEDGER",
    "Log2Histogram",
    "MONITOR",
    "MemoryLedger",
    "MetricHealthError",
    "PROFILER",
    "PressureHandle",
    "Profiler",
    "RetraceMonitor",
    "SLO",
    "SLORegistry",
    "SLOWatchdog",
    "SLO_REGISTRY",
    "SpanTracker",
    "TELEMETRY",
    "TRACER",
    "TelemetryRegistry",
    "WATCHDOG",
    "aggregate_snapshots",
    "apply_pytree",
    "arg_signature",
    "bundle_bytes",
    "burn_rate",
    "degraded_processes",
    "disable",
    "dumps",
    "enable",
    "estimate_clock_offsets",
    "get_health_policy",
    "get_profiling",
    "get_retrace_threshold",
    "get_step",
    "memory_report",
    "merge_snapshots",
    "on_pressure",
    "profile_report",
    "program_cost",
    "pytree_nbytes",
    "render_prometheus",
    "reset",
    "set_health_policy",
    "set_profiling",
    "set_retrace_threshold",
    "set_step",
    "snapshot",
    "snapshot_pytree",
    "step_context",
    "straggler_report",
    "timeline",
    "tracing",
]
