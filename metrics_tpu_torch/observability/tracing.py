"""Fleet-wide tracing: collective spans, clock alignment, stragglers.

Counterpart of ``metrics_tpu/observability/tracing.py``. Every sync
round — the gather protocol's descriptor and payload rounds
(``utilities/distributed.py::_gather_all_leaves``), the packed sync's
buckets (``sync_state_packed``) and the collection's epoch sync — records an
enter/exit interval carrying a **deterministic span id**: a monotonic
sequence per ``(kind, group, bucket)``, counted per process. Every
participant issues the same collectives in the same order, so the N-th
``gather|0,1|transport`` span on rank 0 *is* the N-th on rank 1: the id
joins one collective across the processes with no coordination at record
time, and the ids equal the JAX package's for the same sequence of rounds.
The process is the ``torch.distributed`` rank when a process group is
initialised, else 0.

The fleet half (``tracing.py:323-646``):

* **Clock alignment** (:func:`estimate_clock_offsets`): each process's
  event clock (:meth:`EventLog.now`, a host ``perf_counter``) has its own
  epoch. A small gather handshake estimates every peer's offset with
  ±RTT/2 uncertainty, keeping the lowest-RTT of a few rounds. Under NCCL a
  gather returns once enqueued, so each round reads the gathered clocks to
  the host: one deliberate synchronizing call per round.
* **Fleet merge** (:func:`gather_fleet`): each process ships its event log
  and span ledger as one ragged uint8 JSON leaf through
  :func:`~metrics_tpu_torch.utilities.distributed.gather_all_pytrees` (one
  descriptor round and one payload round), and every timestamp is shifted
  onto the local clock; :func:`metrics_tpu_torch.observability.timeline.export_fleet`
  renders it as one Perfetto trace.
* **Straggler diagnostics** (:func:`straggler_report`,
  :func:`degraded_processes`): each aligned collective splits into the wait
  for the slowest peer and the transfer; a process that arrives last in a
  persistent fraction of collectives is flagged. The published report joins
  ``summary()["straggler"]`` and the ``metrics_tpu_straggler*`` Prometheus
  family, the async engine treats flagged peers as degraded, and each
  flagged process takes one strike in the resilience plane's failure
  detector (:func:`~metrics_tpu_torch.resilience.detector.note_straggler_report`).

Recording a span is a host clock read plus a bounded append; the times are
host times (under NCCL a payload round returns once enqueued).
"""
import json
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from metrics_tpu_torch.observability.events import EVENTS, EventLog
from metrics_tpu_torch.observability.histogram import observe_sync_round_trip
from metrics_tpu_torch.observability.registry import TELEMETRY

#: default bound on retained spans (~150 bytes each)
DEFAULT_SPAN_CAPACITY = 4096

#: fraction of analyzed collectives a process must be the last arriver of
#: before it is flagged as persistently slow
DEFAULT_FLAG_FRACTION = 0.5

#: analyzed collectives required before any process can be flagged
DEFAULT_MIN_SPANS = 2


class CollectiveSpan(NamedTuple):
    """One recorded collective interval on one process.

    ``span_id`` is the cross-process correlation key (deterministic, see the
    module docstring); ``enter_s``/``exit_s`` are seconds on the owning
    process's event-log clock (:meth:`EventLog.now`), so spans and events
    share one timebase per process.
    """

    span_id: str
    kind: str
    group: str
    bucket: str
    seq: int
    process: int
    enter_s: float
    exit_s: float
    step: Optional[int]
    payload: Dict[str, Any]


class _OpenSpan(NamedTuple):
    span_id: str
    kind: str
    group: str
    bucket: str
    seq: int
    process: int
    enter_s: float


def _process_index() -> int:
    """This process's rank in the default ``torch.distributed`` group, 0
    when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class SpanTracker:
    """Bounded, thread-safe ledger of collective spans with deterministic ids.

    One process-global instance (:data:`TRACER`) backs the library; private
    instances are supported for tests. Sequence counters are keyed
    ``(process, kind, group, bucket)`` — per *process* so that simulated
    multi-rank harnesses (threads sharing one tracker) still hand each rank
    its own monotonic sequence, exactly as real per-process trackers would.

    Call sites gate on the lock-free :attr:`enabled` read; a disabled tracker
    costs one attribute read per collective.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_SPAN_CAPACITY,
        enabled: bool = True,
        log: Optional[EventLog] = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"span tracker capacity must be >= 1, got {capacity}")
        self._lock = threading.Lock()
        self._enabled = enabled
        self._capacity = int(capacity)
        self._log = EVENTS if log is None else log
        self._spans: List[CollectiveSpan] = []
        self._seq: Dict[Tuple[int, str, str, str], int] = {}
        self._recorded = 0
        self._dropped = 0
        self._by_kind: Dict[str, int] = {}
        self._fleet_report: Optional[Dict[str, Any]] = None

    # -- enablement (lock-free read) ----------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, on: bool = True) -> None:
        self._enabled = bool(on)

    def disable(self) -> None:
        self._enabled = False

    @property
    def capacity(self) -> int:
        return self._capacity

    # -- recording ----------------------------------------------------------

    def begin(self, kind: str, group: str = "all", bucket: str = "-") -> Optional[_OpenSpan]:
        """Open a span: allocate the next deterministic id for
        ``(kind, group, bucket)`` on this process and stamp the enter time.
        Returns ``None`` when disabled (pass it straight to :meth:`end`)."""
        if not self._enabled:
            return None
        process = _process_index()
        key = (process, str(kind), str(group), str(bucket))
        with self._lock:
            seq = self._seq.get(key, 0)
            self._seq[key] = seq + 1
        span_id = f"{kind}|{group}|{bucket}|{seq}"
        return _OpenSpan(span_id, str(kind), str(group), str(bucket), seq, process, self._log.now())

    def _append(self, span: _OpenSpan, exit_s: float, payload: Dict[str, Any]) -> str:
        record = CollectiveSpan(
            span.span_id,
            span.kind,
            span.group,
            span.bucket,
            span.seq,
            span.process,
            span.enter_s,
            exit_s,
            self._log.get_step(),
            payload,
        )
        with self._lock:
            self._spans.append(record)
            self._recorded += 1
            self._by_kind[span.kind] = self._by_kind.get(span.kind, 0) + 1
            if len(self._spans) > self._capacity:
                del self._spans[0]
                self._dropped += 1
        return record.span_id

    def end(self, span: Optional[_OpenSpan], **payload: Any) -> Optional[str]:
        """Close ``span`` (a no-op for ``None``): stamp the exit time and
        retain the record. ``payload`` must be JSON-serializable. Returns the
        span id."""
        if span is None or not self._enabled:
            return None
        return self._append(span, self._log.now(), payload)

    @contextmanager
    def collective_span(
        self, kind: str, *, group: str = "all", bucket: str = "-", **payload: Any
    ) -> Iterator[Optional[_OpenSpan]]:
        """Scope one collective: ``with TRACER.collective_span("gather",
        group="0,1", bucket="transport") as span: ...``."""
        span = self.begin(kind, group=group, bucket=bucket)
        try:
            yield span
        finally:
            self.end(span, **payload)

    def record_span(
        self,
        kind: str,
        group: str = "all",
        bucket: str = "-",
        *,
        enter_ago_s: float = 0.0,
        exit_ago_s: float = 0.0,
        **payload: Any,
    ) -> Optional[str]:
        """Record an already-elapsed interval after the fact
        (``tracing.py:225``): the span entered ``enter_ago_s`` seconds before
        now and exited ``exit_ago_s`` seconds before now. The serving queue
        records its wait and dispatch spans this way at flush time, from
        endpoints stamped as they happened. Returns the span id."""
        span = self.begin(kind, group=group, bucket=bucket)
        if span is None:
            return None
        enter_ago = max(float(enter_ago_s), 0.0)
        exit_ago = min(max(float(exit_ago_s), 0.0), enter_ago)
        return self._append(span._replace(enter_s=span.enter_s - enter_ago), span.enter_s - exit_ago, payload)

    # -- reading ------------------------------------------------------------

    def records(self) -> List[CollectiveSpan]:
        """A consistent copy of the retained spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def spans_payload(self) -> List[Dict[str, Any]]:
        """The retained spans as JSON-serializable dicts (the fleet-gather
        wire form)."""
        from metrics_tpu_torch.observability.timeline import _json_safe

        out = []
        for s in self.records():
            d = s._asdict()
            d["payload"] = {str(k): _json_safe(v) for k, v in s.payload.items()}
            out.append(d)
        return out

    def set_fleet_report(self, report: Optional[Dict[str, Any]]) -> None:
        """Publish the latest fleet straggler report (joins
        ``snapshot()["tracing"]["straggler"]`` and the Prometheus family)."""
        with self._lock:
            self._fleet_report = report

    @property
    def last_fleet_report(self) -> Optional[Dict[str, Any]]:
        return self._fleet_report

    def summary(self) -> Dict[str, Any]:
        """Compact JSON view for ``snapshot()["tracing"]``."""
        with self._lock:
            return {
                "enabled": self._enabled,
                "capacity": self._capacity,
                "size": len(self._spans),
                "recorded_total": self._recorded,
                "dropped": self._dropped,
                "by_kind": dict(self._by_kind),
                "straggler": self._fleet_report,
            }

    def clear(self) -> None:
        """Drop every span, zero the counters AND the sequence allocators.

        Sequence counters are part of the cross-process correlation contract:
        like any collective, a clear must happen on every process together
        (or on none) or subsequent span ids will not line up fleet-wide."""
        with self._lock:
            self._spans.clear()
            self._seq.clear()
            self._recorded = 0
            self._dropped = 0
            self._by_kind.clear()
            self._fleet_report = None


#: the process-global span tracker every instrumented collective feeds
TRACER = SpanTracker()


def collective_span(kind: str, *, group: str = "all", bucket: str = "-", **payload: Any):
    """Scope a collective span on the global tracker (see
    :meth:`SpanTracker.collective_span`)."""
    return TRACER.collective_span(kind, group=group, bucket=bucket, **payload)


# ---------------------------------------------------------------------------
# clock alignment: the gather handshake
# ---------------------------------------------------------------------------


def estimate_clock_offsets(
    rounds: int = 3, *, now_fn: Optional[Any] = None
) -> Dict[str, Any]:
    """Estimate every peer's clock offset with a tiny gather handshake.

    Each round: read the local clock (``t0``), all-gather one float64 (every
    process's clock reading), read the local clock again (``t1``). A peer's
    reading happened somewhere inside ``[t0, t1]``, so
    ``offset = peer_reading - (t0 + t1) / 2`` estimates (peer clock − local
    clock) with at most ±RTT/2 error — the NTP sampling argument. The lowest
    -RTT round wins (RTT varies far more than clocks drift over a few
    rounds); its RTTs feed the ``sync_round_trip_seconds{transport=
    "handshake"}`` histogram.

    ``now_fn`` defaults to :meth:`EventLog.now` on the global log so offsets
    live in the same timebase as event/span timestamps. **Collective
    discipline applies**: every process must call this together. Returns::

        {"offsets": [s per process, 0.0 for self], "rtt_s": best_round_rtt,
         "uncertainty_s": rtt/2, "rounds": n, "process": local_index}

    ``aligned_peer_ts = peer_ts - offsets[peer]`` maps a peer timestamp onto
    the local clock. Single-process runs return the identity alignment.
    """
    from metrics_tpu_torch.utilities import distributed as _dist

    now = EVENTS.now if now_fn is None else now_fn
    if not _dist.distributed_available():
        return {"offsets": [0.0], "rtt_s": 0.0, "uncertainty_s": 0.0, "rounds": 0, "process": 0}

    nprocs = _dist.world_size()
    me = _process_index()
    device = _dist._exchange_device(None)
    best_rtt: Optional[float] = None
    best_offsets: List[float] = [0.0] * nprocs
    rounds = max(1, int(rounds))
    for _ in range(rounds):
        t0 = now()
        # a fill, not a copy from the host: the clock reading rides the
        # round's own buffer; reading the gather back is the round's one
        # deliberate host wait (under NCCL the gather returns once enqueued)
        reading = torch.full((1,), now(), dtype=torch.float64, device=device)
        gathered = _dist._all_gather(reading, None).cpu().numpy().reshape(-1)
        t1 = now()
        rtt = max(0.0, t1 - t0)
        mid = 0.5 * (t0 + t1)
        if TELEMETRY.enabled:
            observe_sync_round_trip(rtt, transport="handshake")
        if best_rtt is None or rtt < best_rtt:
            best_rtt = rtt
            best_offsets = [float(gathered[i] - mid) for i in range(nprocs)]
    best_offsets[me] = 0.0
    return {
        "offsets": best_offsets,
        "rtt_s": round(float(best_rtt or 0.0), 9),
        "uncertainty_s": round(float(best_rtt or 0.0) / 2.0, 9),
        "rounds": rounds,
        "process": me,
    }


# ---------------------------------------------------------------------------
# fleet merge: gather + align every process's events and spans
# ---------------------------------------------------------------------------


def gather_fleet(
    *,
    handshake_rounds: int = 3,
    log: Optional[EventLog] = None,
    tracker: Optional[SpanTracker] = None,
) -> Dict[str, Any]:
    """Gather every process's event log and span ledger, clock-aligned.

    A collective (every process must call together): runs the clock
    handshake, then ships each process's ``{events, spans}`` as one ragged
    uint8 JSON leaf through
    :func:`~metrics_tpu_torch.utilities.distributed.gather_all_pytrees` — the same
    ONE-descriptor-round + ONE-payload-round transport metric state syncs
    over. Every timestamp in the result is shifted onto the LOCAL process's
    clock (``ts - offsets[process]``), so intervals compare directly across
    tracks; the residual error is bounded by the handshake's ±RTT/2.

    Span and event records stamped with a ``process`` are filtered to their
    stamping process (a no-op in real deployments where each process only
    holds its own records; it keeps simulated shared-ledger harnesses
    faithful). Returns::

        {"processes": [{"process": i, "epoch_unix": float,
                        "events": [...], "spans": [...]}, ...],
         "clock": <estimate_clock_offsets result>}
    """
    from metrics_tpu_torch.observability.timeline import _json_safe
    from metrics_tpu_torch.utilities import distributed as _dist

    log = EVENTS if log is None else log
    tracker = TRACER if tracker is None else tracker

    clock = estimate_clock_offsets(handshake_rounds, now_fn=log.now)

    events = []
    for ev in log.events():
        d = ev._asdict()
        d["payload"] = {str(k): _json_safe(v) for k, v in ev.payload.items()}
        events.append(d)
    blob = {
        "process": _process_index(),
        "epoch_unix": log.epoch_unix,
        "events": events,
        "spans": tracker.spans_payload(),
    }
    payload = torch.frombuffer(bytearray(json.dumps(blob).encode("utf-8")), dtype=torch.uint8)
    gathered = _dist.gather_all_pytrees([payload])[0]
    blobs = [json.loads(bytes(buf.cpu().numpy()).decode("utf-8")) for buf in gathered]

    offsets = clock["offsets"]
    processes: List[Dict[str, Any]] = []
    for blob in blobs:
        p = int(blob.get("process", 0))
        off = float(offsets[p]) if p < len(offsets) else 0.0
        spans = []
        for s in blob.get("spans", []):
            if int(s.get("process", p)) != p:
                continue
            s = dict(s)
            s["enter_s"] = float(s["enter_s"]) - off
            s["exit_s"] = float(s["exit_s"]) - off
            spans.append(s)
        evs = []
        for e in blob.get("events", []):
            if int(e.get("payload", {}).get("process", p)) != p:
                continue
            e = dict(e)
            e["ts_s"] = float(e["ts_s"]) - off
            evs.append(e)
        processes.append(
            {
                "process": p,
                "epoch_unix": blob.get("epoch_unix"),
                "events": evs,
                "spans": spans,
            }
        )
    processes.sort(key=lambda entry: entry["process"])
    return {"processes": processes, "clock": clock}


# ---------------------------------------------------------------------------
# straggler / skew diagnostics
# ---------------------------------------------------------------------------

#: (kind, bucket) of the spans the straggler analysis correlates — the eager
#: transport round-trip, the one span level per collective (sub-rounds and
#: wrapping metric-sync spans would double-count the same barrier)
ANALYZED_SPANS = (("gather", "transport"),)


def _percentile(values: Sequence[float], q: float) -> float:
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def straggler_report(
    fleet: Union[Dict[str, Any], List[Dict[str, Any]]],
    *,
    flag_fraction: float = DEFAULT_FLAG_FRACTION,
    min_spans: int = DEFAULT_MIN_SPANS,
    min_lag_s: float = 0.0,
    publish: bool = False,
    tracker: Optional[SpanTracker] = None,
) -> Dict[str, Any]:
    """Decompose clock-aligned collectives into wait vs transfer time and
    flag persistently slow processes.

    ``fleet`` is a :func:`gather_fleet` result (or its ``processes`` list).
    Spans whose ``(kind, bucket)`` is in :data:`ANALYZED_SPANS` and whose
    ``span_id`` appears on >= 2 process tracks are correlated; per collective:

    * ``last_enter = max(enter)`` — the moment the slowest peer arrived;
    * each process's **wait** is ``last_enter - enter`` (time parked at the
      barrier for the slowest peer) and its **transfer** is
      ``exit - last_enter`` (the data actually moving);
    * the process with the latest enter is the collective's **straggler**,
      and each process's **lag** is ``enter - first_enter``.

    A process is **flagged** when it was the straggler in at least
    ``flag_fraction`` of the (>= ``min_spans``) analyzed collectives and its
    median lag is >= ``min_lag_s`` — the trigger
    :func:`degraded_processes` exposes for retry/stale-read/quorum policies.
    Lag/skew values inherit the clock alignment's ±RTT/2 uncertainty
    (reported under ``clock_uncertainty_s``); pass a ``min_lag_s`` above it
    when flagging on small skews.

    ``publish=True`` additionally stores the report on the tracker (default
    the global :data:`TRACER`) for ``snapshot()``/Prometheus and records one
    ``straggler`` event per flagged process.
    """
    processes = fleet.get("processes", []) if isinstance(fleet, dict) else list(fleet)
    clock = fleet.get("clock", {}) if isinstance(fleet, dict) else {}

    analyzed = set(ANALYZED_SPANS)
    by_id: Dict[str, Dict[int, Tuple[float, float]]] = {}
    for entry in processes:
        p = int(entry["process"])
        for s in entry.get("spans", []):
            if (s.get("kind"), s.get("bucket")) not in analyzed:
                continue
            by_id.setdefault(s["span_id"], {})[p] = (float(s["enter_s"]), float(s["exit_s"]))

    per_proc: Dict[int, Dict[str, List[float]]] = {
        int(entry["process"]): {"lag": [], "wait": [], "transfer": [], "straggler": []}
        for entry in processes
    }
    skews: List[float] = []
    collectives = 0
    for span_id, members in by_id.items():
        if len(members) < 2:
            continue
        collectives += 1
        enters = {p: t[0] for p, t in members.items()}
        first_enter = min(enters.values())
        last_enter = max(enters.values())
        straggler = max(enters, key=lambda p: (enters[p], p))
        skews.append(last_enter - first_enter)
        for p, (enter, exit_) in members.items():
            stats = per_proc.setdefault(
                p, {"lag": [], "wait": [], "transfer": [], "straggler": []}
            )
            stats["lag"].append(enter - first_enter)
            stats["wait"].append(last_enter - enter)
            stats["transfer"].append(max(0.0, exit_ - last_enter))
            stats["straggler"].append(1.0 if p == straggler else 0.0)

    report_procs: Dict[str, Dict[str, Any]] = {}
    flagged: List[int] = []
    for p in sorted(per_proc):
        stats = per_proc[p]
        n = len(stats["lag"])
        straggler_count = int(sum(stats["straggler"]))
        fraction = (straggler_count / n) if n else 0.0
        lag_p50 = _percentile(stats["lag"], 50.0)
        entry = {
            "spans": n,
            "straggler_count": straggler_count,
            "straggler_fraction": round(fraction, 6),
            "lag_p50_s": round(lag_p50, 9),
            "lag_p95_s": round(_percentile(stats["lag"], 95.0), 9),
            "lag_max_s": round(max(stats["lag"], default=0.0), 9),
            "wait_s": round(float(sum(stats["wait"])), 9),
            "transfer_s": round(float(sum(stats["transfer"])), 9),
        }
        if n >= min_spans and fraction >= flag_fraction and lag_p50 >= min_lag_s:
            flagged.append(p)
        report_procs[str(p)] = entry

    report = {
        "collectives": collectives,
        "skew_p50_s": round(_percentile(skews, 50.0), 9),
        "skew_p95_s": round(_percentile(skews, 95.0), 9),
        "skew_max_s": round(max(skews, default=0.0), 9),
        "clock_uncertainty_s": float(clock.get("uncertainty_s", 0.0)),
        "processes": report_procs,
        "flagged": flagged,
        "params": {
            "flag_fraction": flag_fraction,
            "min_spans": min_spans,
            "min_lag_s": min_lag_s,
        },
    }

    if publish:
        tracker = TRACER if tracker is None else tracker
        tracker.set_fleet_report(report)
        if EVENTS.enabled:
            for p in flagged:
                entry = report_procs[str(p)]
                EVENTS.record(
                    "straggler",
                    None,
                    process=int(p),
                    straggler_fraction=entry["straggler_fraction"],
                    lag_p50_s=entry["lag_p50_s"],
                    lag_p95_s=entry["lag_p95_s"],
                    collectives=collectives,
                )
        if flagged:
            # one strike of evidence each in the failure detector (guarded:
            # the detector must never break a report)
            try:
                from metrics_tpu_torch.resilience.detector import note_straggler_report

                note_straggler_report(flagged)
            except Exception:  # pragma: no cover - diagnostics only
                pass
    return report


def degraded_processes(
    report: Optional[Dict[str, Any]] = None, *, tracker: Optional[SpanTracker] = None
) -> List[int]:
    """Process indices the latest straggler report flagged as persistently
    slow (empty when no fleet report has been published) — the query the
    degraded-link policies (retry, stale-read, quorum; ROADMAP items 3-4)
    trigger on (the async engine's ``_degraded()``)."""
    if report is None:
        report = (TRACER if tracker is None else tracker).last_fleet_report
    if not report:
        return []
    return [int(p) for p in report.get("flagged", [])]


def summary() -> Dict[str, Any]:
    """The global tracker's compact view (``snapshot()["tracing"]``)."""
    return TRACER.summary()
