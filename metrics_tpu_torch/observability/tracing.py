"""Collective spans with deterministic ids: the span tracker.

Counterpart of the first half of ``metrics_tpu/observability/tracing.py``
(``SpanTracker``, ``TRACER``, ``collective_span``, ``summary``). Every sync
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

The fleet half of the JAX module (``estimate_clock_offsets``,
``gather_fleet``, ``straggler_report``, ``degraded_processes``) is not
ported yet (ROADMAP queue A item 13), so ``summary()["straggler"]`` stays
``None``.

Recording a span is a host clock read plus a bounded append; the times are
host times (under NCCL a payload round returns once enqueued).
"""
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch.distributed as dist

from metrics_tpu_torch.observability.events import EVENTS, EventLog

#: default bound on retained spans (~150 bytes each)
DEFAULT_SPAN_CAPACITY = 4096


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
                # the fleet straggler report comes with the fleet half
                "straggler": None,
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


#: the process-global span tracker every instrumented collective feeds
TRACER = SpanTracker()


def collective_span(kind: str, *, group: str = "all", bucket: str = "-", **payload: Any):
    """Scope a collective span on the global tracker (see
    :meth:`SpanTracker.collective_span`)."""
    return TRACER.collective_span(kind, group=group, bucket=bucket, **payload)
