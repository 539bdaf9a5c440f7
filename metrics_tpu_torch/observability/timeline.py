"""Chrome-trace/Perfetto JSON export of the structured event log.

Counterpart of ``metrics_tpu/observability/timeline.py`` (a copy: the JAX
module imports no JAX). Renders :mod:`~metrics_tpu_torch.observability.events`
as per-metric tracks in the `Trace Event Format`_ — the JSON that
``chrome://tracing``, Perfetto, and ``torch.profiler``'s own
``export_chrome_trace`` speak — so a whole run's metric activity (updates,
forwards, computes, gather rounds, retraces, health flags, profile samples)
is inspectable on one timeline next to a device trace::

    from metrics_tpu_torch.observability import timeline
    timeline.export("/tmp/metrics-timeline.json")   # load in ui.perfetto.dev

Mapping: each distinct metric key becomes one named thread-track (global
events such as gather transports ride the ``<global>`` track); interval
events (``dur_s > 0``) render as complete ``"X"`` slices, instantaneous ones
(retrace, trace-time sync, health) as thread-scoped ``"i"`` instants; the
user's step counter additionally renders as a ``"C"`` counter track so slices
line up against step boundaries. Timestamps are microseconds on the event
log's shared monotonic clock.

:func:`export_fleet` is the multi-process form: every process's event log
and collective-span ledger (:mod:`~metrics_tpu_torch.observability.tracing`) merge
into ONE trace — one Perfetto *process* track per process (its ``torch.distributed`` rank), timestamps
clock-aligned by the gather handshake, the same collective's spans connected
across processes by flow arrows, and the straggler report embedded in
``otherData``.

.. _Trace Event Format:
   https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from metrics_tpu_torch.observability.events import EVENTS, Event, EventLog

#: track name for events not owned by a single metric (gather transports)
GLOBAL_TRACK = "<global>"

#: track name collective spans render on (per process in the fleet view)
COLLECTIVES_TRACK = "<collectives>"

#: track name the request-scoped serving spans render on (submit →
#: enqueue-wait → dispatch → read, joined by flow arrows)
SERVING_TRACK = "<serving>"


def _json_safe(value: Any) -> Any:
    """Best-effort coercion of payload values the recorders hand us (tuples,
    numpy scalars) into plain JSON types; unknown objects degrade to repr."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:  # pragma: no cover - exotic array-likes
            pass
    return repr(value)


def _track_allocator(trace: List[Dict[str, Any]], pid: int) -> Any:
    """A per-process thread-track allocator: hands out stable tids and emits
    the ``thread_name`` metadata exactly once per track."""
    tids: Dict[str, int] = {}

    def tid_for(track: str) -> int:
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
            trace.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": track},
                }
            )
        return tid

    return tid_for


def _append_events(
    trace: List[Dict[str, Any]], pid: int, events: Sequence[Event], tid_for: Any
) -> None:
    """Emit one process's events: per-metric slices/instants plus the step
    counter track (the single-process and fleet exporters share this)."""
    last_step: Optional[int] = None
    for ev in sorted(events, key=lambda e: (e.ts_s, e.seq)):
        tid = tid_for(ev.metric if ev.metric is not None else GLOBAL_TRACK)
        if ev.step is not None and ev.step != last_step:
            last_step = ev.step
            trace.append(
                {
                    "ph": "C",
                    "name": "step",
                    "pid": pid,
                    "tid": 0,
                    "ts": round(ev.ts_s * 1e6, 3),
                    "args": {"step": ev.step},
                }
            )
        args = {str(k): _json_safe(v) for k, v in ev.payload.items()}
        if ev.step is not None:
            args["step"] = ev.step
        record: Dict[str, Any] = {
            "name": f"{ev.metric}.{ev.kind}" if ev.metric else ev.kind,
            "cat": ev.kind,
            "pid": pid,
            "tid": tid,
            "ts": round(ev.ts_s * 1e6, 3),
            "args": args,
        }
        if ev.dur_s > 0:
            record["ph"] = "X"
            record["dur"] = round(ev.dur_s * 1e6, 3)
        else:
            record["ph"] = "i"
            record["s"] = "t"
        trace.append(record)


def _append_serving_spans(
    trace: List[Dict[str, Any]], pid: int, tid_for: Any, spans: Sequence[Any]
) -> None:
    """Render the ``serving``-kind spans as a ``<serving>`` track of slices
    plus request-scoped flow arrows:

    * **submit → dispatch**: a dispatch span's payload carries the cohort
      (submit-span) ids it coalesced; each cohort present in the ledger gets
      one flow start at its submit slice and a finish at every dispatch
      slice that drained rows from it.
    * **dispatch → read**: a read span's ``flush_span`` payload references
      the dispatch that produced the cache it served; each referenced
      dispatch gets one flow start at its exit and a finish at every such
      read.

    Starts and finishes are emitted together, only for chains whose BOTH
    endpoints survive in the bounded span ledger — a dangling flow is the
    silent-drop failure mode ``check_trace.py`` exists to catch."""
    serving = [s for s in spans if s.kind == "serving"]
    if not serving:
        return
    tid = tid_for(SERVING_TRACK)
    by_id = {s.span_id: s for s in serving}
    for s in sorted(serving, key=lambda s: (s.enter_s, s.seq)):
        args = {str(k): _json_safe(v) for k, v in s.payload.items()}
        args.update(span_id=s.span_id, group=s.group, seq=s.seq)
        if s.step is not None:
            args["step"] = s.step
        trace.append(
            {
                "ph": "X",
                "name": f"serving.{s.bucket}",
                "cat": "serving",
                "pid": pid,
                "tid": tid,
                "ts": round(s.enter_s * 1e6, 3),
                "dur": round(max(0.0, s.exit_s - s.enter_s) * 1e6, 3),
                "args": args,
            }
        )
    # chain id -> (start ts_s, [finish ts_s, ...]); ids are span ids, which
    # are unique per chain kind (submit ids vs dispatch ids)
    chains: Dict[str, Any] = {}
    for s in serving:
        if s.bucket == "dispatch":
            for cohort in s.payload.get("cohorts") or []:
                sub = by_id.get(cohort)
                if sub is not None:
                    chains.setdefault(cohort, (sub.enter_s, []))[1].append(
                        max(s.enter_s, sub.enter_s)
                    )
        elif s.bucket == "read":
            flush = s.payload.get("flush_span")
            disp = by_id.get(flush) if flush else None
            if disp is not None:
                # the read ends after the cache its flush fed was installed,
                # so the finish lands at the read's exit (never before the
                # dispatch's own exit — a miss overlaps its refresh)
                chains.setdefault(flush, (disp.exit_s, []))[1].append(
                    max(s.exit_s, disp.exit_s)
                )
    for chain_id in sorted(chains):
        start_ts, finishes = chains[chain_id]
        trace.append(
            {
                "ph": "s",
                "name": "serving_request",
                "cat": "serving_flow",
                "id": chain_id,
                "pid": pid,
                "tid": tid,
                "ts": round(start_ts * 1e6, 3),
                "args": {"span_id": chain_id},
            }
        )
        for f_ts in sorted(finishes):
            trace.append(
                {
                    "ph": "f",
                    "bp": "e",
                    "name": "serving_request",
                    "cat": "serving_flow",
                    "id": chain_id,
                    "pid": pid,
                    "tid": tid,
                    "ts": round(f_ts * 1e6, 3),
                    "args": {"span_id": chain_id},
                }
            )


def _append_memory_counters(
    trace: List[Dict[str, Any]], pid: int, log: EventLog
) -> None:
    """Render the memory ledger's tracked-bytes samples as a ``"C"``
    counter track (``memory.tracked_bytes``), so HBM occupancy reads
    against the dispatch slices. The ledger stamps samples on
    ``perf_counter`` — the event log's clock — so ``log.now()`` gives the
    exact offset onto the log's epoch. Empty when nothing is tracked."""
    from metrics_tpu_torch.observability.memory import LEDGER

    samples = LEDGER.samples()
    if not samples:
        return
    offset = log.now() - time.perf_counter()
    for ts, tracked in samples:
        trace.append(
            {
                "ph": "C",
                "name": "memory.tracked_bytes",
                "pid": pid,
                "tid": 0,
                "ts": round((ts + offset) * 1e6, 3),
                "args": {"tracked_bytes": int(tracked)},
            }
        )


def to_chrome_trace(
    events: Optional[Sequence[Event]] = None,
    log: Optional[EventLog] = None,
    tracker: Optional[Any] = None,
) -> Dict[str, Any]:
    """Build the Chrome-trace dict (``{"traceEvents": [...], ...}``) from
    ``events`` (default: the global log's retained events) plus the serving
    track (``tracker`` defaults to the global
    :data:`~metrics_tpu_torch.observability.tracing.TRACER`; its ``serving``-kind
    spans render as slices with request flow arrows)."""
    from metrics_tpu_torch.observability.tracing import TRACER

    log = EVENTS if log is None else log
    if events is None:
        events = log.events()
    if tracker is None:
        tracker = TRACER
    pid = os.getpid()

    trace: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "args": {"name": "metrics_tpu_torch"},
        }
    ]
    tid_for = _track_allocator(trace, pid)
    _append_events(trace, pid, events, tid_for)
    _append_serving_spans(trace, pid, tid_for, tracker.records())
    _append_memory_counters(trace, pid, log)

    return {
        "traceEvents": trace,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "metrics_tpu_torch.observability.timeline",
            "epoch_unix_s": log.epoch_unix,
            "events_summary": log.summary(),
        },
    }


def export(
    path: str,
    events: Optional[Sequence[Event]] = None,
    log: Optional[EventLog] = None,
    tracker: Optional[Any] = None,
) -> str:
    """Write the Chrome-trace JSON to ``path`` and return ``path``. The file
    loads directly in ``chrome://tracing`` and https://ui.perfetto.dev.

    Missing parent directories are created (the usual call site is an
    end-of-run hook writing into a per-run artifact dir that may not exist
    yet), and a never-written/empty event log exports a VALID empty trace —
    the process-name metadata plus an empty-summary ``otherData`` block —
    so an early-exit run's artifact still loads in the viewers."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    trace = to_chrome_trace(events, log=log, tracker=tracker)
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return path


# ---------------------------------------------------------------------------
# fleet export: one merged, clock-aligned trace for every process
# ---------------------------------------------------------------------------


def _event_from_dict(d: Dict[str, Any]) -> Event:
    return Event(
        int(d.get("seq", 0)),
        str(d.get("kind", "update")),
        d.get("metric"),
        d.get("step"),
        float(d.get("ts_s", 0.0)),
        float(d.get("dur_s", 0.0)),
        dict(d.get("payload") or {}),
    )


def to_fleet_chrome_trace(
    fleet: Dict[str, Any], report: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """Build the merged Chrome-trace dict from a
    :func:`~metrics_tpu_torch.observability.tracing.gather_fleet` result.

    Each process becomes one Perfetto process track (``pid`` = process
    index) holding its per-metric event tracks plus a ``<collectives>``
    track of span slices; the same collective's spans — identified by their
    deterministic span id — are connected across processes by flow events
    (``ph: s/t/f`` with a shared ``id``), and ``otherData`` carries the
    clock-alignment evidence and the straggler ``report``.
    """
    trace: List[Dict[str, Any]] = []
    flow_tids: Dict[int, int] = {}
    spans_by_id: Dict[str, List[Dict[str, Any]]] = {}

    for entry in fleet.get("processes", []):
        pid = int(entry["process"])
        trace.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"metrics_tpu_torch process {pid}"},
            }
        )
        trace.append(
            {
                "ph": "M",
                "name": "process_sort_index",
                "pid": pid,
                "tid": 0,
                "args": {"sort_index": pid},
            }
        )
        tid_for = _track_allocator(trace, pid)
        _append_events(trace, pid, [_event_from_dict(e) for e in entry.get("events", [])], tid_for)

        span_tid = tid_for(COLLECTIVES_TRACK)
        flow_tids[pid] = span_tid
        for s in sorted(entry.get("spans", []), key=lambda s: (s["enter_s"], s.get("seq", 0))):
            dur_s = float(s["exit_s"]) - float(s["enter_s"])
            args = {str(k): _json_safe(v) for k, v in (s.get("payload") or {}).items()}
            args.update(
                span_id=s["span_id"], group=s.get("group"), bucket=s.get("bucket"),
                seq=s.get("seq"),
            )
            if s.get("step") is not None:
                args["step"] = s["step"]
            record: Dict[str, Any] = {
                "name": f"{s['kind']}[{s.get('bucket', '-')}]",
                "cat": "collective",
                "pid": pid,
                "tid": span_tid,
                "ts": round(float(s["enter_s"]) * 1e6, 3),
                "args": args,
            }
            if dur_s > 0:
                record["ph"] = "X"
                record["dur"] = round(dur_s * 1e6, 3)
            else:
                record["ph"] = "i"
                record["s"] = "t"
            trace.append(record)
            spans_by_id.setdefault(s["span_id"], []).append({**s, "pid": pid})

    # flow arrows: the same collective across processes. Emitted after the
    # slices (flow events bind by id, not by array order); start on the
    # earliest-entering process, finish on the latest, steps in between.
    flow_id = 0
    for span_id in sorted(spans_by_id):
        members = spans_by_id[span_id]
        if len(members) < 2:
            continue
        flow_id += 1
        members = sorted(members, key=lambda s: (float(s["enter_s"]), s["pid"]))
        for i, s in enumerate(members):
            record = {
                "name": s["kind"],
                "cat": "collective_flow",
                "id": flow_id,
                "pid": s["pid"],
                "tid": flow_tids[s["pid"]],
                "ts": round(float(s["enter_s"]) * 1e6, 3),
                "args": {"span_id": span_id},
            }
            if i == 0:
                record["ph"] = "s"
            elif i == len(members) - 1:
                record["ph"] = "f"
                record["bp"] = "e"
            else:
                record["ph"] = "t"
            trace.append(record)

    other: Dict[str, Any] = {
        "producer": "metrics_tpu_torch.observability.timeline.export_fleet",
        "processes": len(fleet.get("processes", [])),
        "clock": _json_safe(fleet.get("clock", {})),
    }
    if report is not None:
        other["straggler_report"] = _json_safe(report)
    return {"traceEvents": trace, "displayTimeUnit": "ms", "otherData": other}


def export_fleet(
    path: str,
    *,
    handshake_rounds: int = 3,
    log: Optional[EventLog] = None,
    tracker: Optional[Any] = None,
    straggler_kwargs: Optional[Dict[str, Any]] = None,
) -> str:
    """Gather, clock-align, and merge EVERY process's timeline into one
    Perfetto trace at ``path`` (returns ``path``).

    A collective — every participating process must call together, like any
    gather (each writes its own ``path``; single-process runs degrade to a
    one-track fleet). The pipeline: a clock handshake estimates per-process
    offsets (±RTT/2), one packed ``gather_all_pytrees`` round-trip ships
    every process's event log + collective-span ledger, timestamps shift
    onto the local clock, and the merged trace gets per-process tracks with
    flow arrows connecting each collective's spans
    (:func:`to_fleet_chrome_trace`). The straggler report is computed from
    the aligned spans, **published** (``snapshot()["tracing"]["straggler"]``,
    the ``metrics_tpu_straggler*`` Prometheus family, one ``straggler``
    event per flagged process), and embedded in the trace's ``otherData``;
    ``straggler_kwargs`` forwards thresholds to
    :func:`~metrics_tpu_torch.observability.tracing.straggler_report`.
    """
    from metrics_tpu_torch.observability import tracing

    fleet = tracing.gather_fleet(
        handshake_rounds=handshake_rounds, log=log, tracker=tracker
    )
    report = tracing.straggler_report(
        fleet, publish=True, tracker=tracker, **(straggler_kwargs or {})
    )
    doc = to_fleet_chrome_trace(fleet, report)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path
