"""Runtime telemetry of the port: one snapshot of counters, events, spans.

Counterpart of ``metrics_tpu/observability/__init__.py``, limited to the
telemetry core:

* :mod:`~metrics_tpu_torch.observability.registry` — thread-safe
  per-metric counters (update/forward/compute/reset, keyed rows, invalid
  tenant ids, sketch merges) and wall-time histograms, plus sync stats;
* :mod:`~metrics_tpu_torch.observability.events` — the bounded,
  step-correlated event log (:data:`EVENTS`, :func:`set_step`,
  :func:`step_context`);
* :mod:`~metrics_tpu_torch.observability.histogram` — fixed-bucket log2
  histograms (:data:`HISTOGRAMS`: dispatch times, sync round trips, gather
  payload sizes) with windowed views;
* :mod:`~metrics_tpu_torch.observability.tracing` — collective spans with
  deterministic ids (:data:`TRACER`);
* :mod:`~metrics_tpu_torch.observability.export` — :func:`snapshot` (a
  JSON-serializable dict) and :func:`render_prometheus`.

Telemetry is on by default, as in the JAX package. Every call site gates on
a lock-free ``enabled`` read and records host-side facts only: no
instrumented path reads a tensor to the host or synchronizes the card, so
its times are host times (the time to enqueue work on the card). The
kernels' dispatch counters (``snapshot()["kernels"]``) count whether
telemetry is on or off. Typical scrape::

    from metrics_tpu_torch import observability
    snap = observability.snapshot()           # JSON-serializable dict
    text = observability.render_prometheus()  # Prometheus text format

The snapshot also carries the ``async_sync``, ``serving`` and
``resilience`` sections of the planes that fill them. The JAX package's
health, retrace, cost, SLO, memory, profiling, timeline, aggregation and
fleet-tracing pieces are not ported yet (ROADMAP queue A item 13).
"""
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
from metrics_tpu_torch.observability.histogram import (  # noqa: F401
    HISTOGRAMS,
    HistogramRegistry,
    HistogramWindow,
    Log2Histogram,
)
from metrics_tpu_torch.observability.registry import TELEMETRY, TelemetryRegistry  # noqa: F401
from metrics_tpu_torch.observability.tracing import TRACER, CollectiveSpan, SpanTracker  # noqa: F401


def enable(on: bool = True) -> None:
    """Turn telemetry, event recording AND collective-span tracing on (the
    default) or off process-wide."""
    TELEMETRY.enable(on)
    EVENTS.enable(on)
    TRACER.enable(on)


def disable() -> None:
    """Stop recording; instrumented call sites reduce to attribute reads."""
    TELEMETRY.disable()
    EVENTS.disable()
    TRACER.disable()


def reset() -> None:
    """Clear all recorded counters, timers, sync stats, events, histograms
    (window rings included), collective spans, and the async engine's,
    serving plane's and resilience plane's counters; enablement and the step
    tag survive, and so do the kernels' dispatch counters. Span-id sequence
    counters and async generations reset too — like any collective, reset on
    every process together or on none."""
    import sys

    TELEMETRY.reset()
    EVENTS.clear()
    HISTOGRAMS.reset()
    TRACER.clear()
    async_sync = sys.modules.get("metrics_tpu_torch.utilities.async_sync")
    if async_sync is not None and async_sync._ENGINE is not None:
        async_sync._ENGINE.reset()
    serving = sys.modules.get("metrics_tpu_torch.serving.telemetry")
    if serving is not None:
        serving.SERVING_STATS.reset()
    resilience = sys.modules.get("metrics_tpu_torch.resilience.telemetry")
    if resilience is not None:
        resilience.RESILIENCE_STATS.reset()


__all__ = [
    "CollectiveSpan",
    "EVENTS",
    "EVENT_KINDS",
    "Event",
    "EventLog",
    "HISTOGRAMS",
    "HistogramRegistry",
    "HistogramWindow",
    "Log2Histogram",
    "SpanTracker",
    "TELEMETRY",
    "TRACER",
    "TelemetryRegistry",
    "disable",
    "dumps",
    "enable",
    "get_step",
    "render_prometheus",
    "reset",
    "set_step",
    "snapshot",
    "step_context",
]
