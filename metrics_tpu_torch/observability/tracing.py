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

**Host spans** (:meth:`SpanTracker.span`, :func:`span`) time the phases of
the port's own host path where the work happens, so that one keyed
update's host time splits into its parts::

    with TRACER.span("my.phase", batch=7) as s:
        ...
        s.note(rows=4096)           # attributes known only later
    TRACER.host_records()           # HostRequest records, oldest first

* **Off** (the tracker disabled, as ``observability.disable()`` leaves it,
  and no ``torch.profiler`` running): one shared null context, after two
  flag reads.
* **Under an active torch profiler**: a ``metrics/<name>`` range
  (:func:`~metrics_tpu_torch.utilities.profiling.compiled_scope`, the
  ranges the metrics' phases open), so in any profiler trace a span sits
  over the kernels it launched, on the device trace's clock.
* **On**: the outermost open span on a thread is a *request*. A span
  inside it appends nothing: on exit it adds its self time (its length
  less the spans directly inside it) to the request's ``phases`` under its
  name. The request, on exit, is one :class:`HostRequest` appended to a
  ring of its own: its id (``<name>|<n>``, a sequence a name), its
  ``enter_s``/``exit_s`` on the event-log clock (:meth:`EventLog.now`),
  ``thread``, ``profiled`` (a profiler was active, which slows the host),
  ``spans`` (itself and every span inside it), ``host_reads``, ``attrs``,
  ``rows_batched`` and ``merged_leaves``. The phases' self times sum to the
  request's length.

The spans of the keyed wrapper (:mod:`~metrics_tpu_torch.wrappers.multitenant`):
``keyed.update`` (attrs ``rows``, ``bundles``, ``path`` ``"eager"`` or
``"compiled"``), the whole of ``MultiTenantCollection.update`` and
``KeyedMetric.update``; inside it, for each state bundle, ``checks`` (the
child's input checks on the whole batch, :mod:`~metrics_tpu_torch.utilities.checks`),
``row_states`` (the per-row child states,
:func:`~metrics_tpu_torch.utilities.stacked.row_states`, in its batched-rows
form or vmapped; each bundle whose rows took the batched form counts one in
the request's ``rows_batched``, :meth:`SpanTracker.note_rows_batched`, and
in ``summary()["host"]["rows_batched"]``) and ``scatter`` (one for the
update: the merge's host side, the leaves' table and its one launch, and
the routes of the leaves outside it; the leaves that took the merge count
in the request's ``merged_leaves``, :meth:`SpanTracker.note_merged_leaves`,
and in ``summary()["host"]["merged_leaves"]``); and a ``host_read`` span for each read of tensor
values to the host (:func:`~metrics_tpu_torch.utilities.data.to_host`),
counted in the request's ``host_reads`` and in ``summary()["host"]
["host_reads"]``. The request's own phase holds the rest: id
canonicalization, the lock, setting the states, the telemetry. Inside a
compiled program's run (a CUDA-graph capture on the card, every call on
the CPU) a span records nothing, so a compiled keyed update is a request
with ``path="compiled"``, no phase but its own and ``rows_batched`` and
``merged_leaves`` 0.

The eager ``MetricCollection.update`` is a request of its own,
``collection.update`` (attrs ``path`` ``"eager"``, ``members`` and
``shared_members``, the members fed a shared-update class's deltas).
Inside it: ``shared_update`` (each shared-update class's
``_batch_deltas``: the canonicalization and the B1 or B2 launch),
``member_update`` (each member updated alone, and each member's
``_update_from_deltas``), ``checks`` (the input checks where they run:
``utilities/checks.py::_check_inputs_with_ranges`` and the confusion
matrix's label range, wherever values can be read) and ``host_read``; its
own phase holds the rest (the group bookkeeping and the loop). These inner
spans are phases (:meth:`SpanTracker.phase`): each is a part of the request
open on this thread and nothing else, so a ``Metric`` updated on its own
records no request for them, and a keyed update, whose ``checks`` span
already holds the input checks, keeps exactly its phases.
``Metric`` opens no host span of its own: its ``metrics/<Metric>.<phase>``
ranges stay profiler-only, and a child's ``metrics/<Metric>.update`` range
nests under ``row_states`` in either form.

The host-read counter sees the reads written as ``to_host``: every
``.tolist()``, ``.item()`` and ``.numpy()`` of the package and every
``int``/``float``/``bool`` of a reduction (an AST scan in the port's tests
keeps it so, bar a named list). It does not see an implicit read (a tensor
in an ``if``) or a wait for a data-dependent shape (a boolean mask,
``nonzero``, ``unique``); on the keyed update's path a test counts every
form of read and finds only ``to_host``'s.

The host ring is apart from the collective ledger, so
:meth:`SpanTracker.records`, :meth:`SpanTracker.spans_payload`, the fleet
gather and the timeline stay as the JAX package's. It holds the last
:data:`DEFAULT_HOST_CAPACITY` requests, a ``deque`` that drops its oldest
and counts it, as the collective ledger is; ``summary()["host"]`` gives
its ``capacity``, ``size``, ``recorded``, ``dropped`` and the
``host_reads``, ``rows_batched`` and ``merged_leaves`` totals, and
:meth:`SpanTracker.clear`
empties both rings.
Off, a span costs a method call and two flag reads, a phase one; on, a span inside a
request costs two clock reads and a dict update, a request one more record
and one append under the lock (``scripts/torch_span_cost.py``).
"""
import itertools
import json
import threading
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from metrics_tpu_torch.observability.events import EVENTS, EventLog
from metrics_tpu_torch.observability.histogram import observe_sync_round_trip
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.utilities.profiling import compiled_scope

#: default bound on retained spans (~150 bytes each)
DEFAULT_SPAN_CAPACITY = 4096

#: bound on retained host requests (about 0.5 KB each with a few phases)
DEFAULT_HOST_CAPACITY = 16384

#: the name of the host span of one read of tensor values to the host, each
#: counted in its request's ``host_reads`` and in ``summary()["host"]``
HOST_READ = "host_read"

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


class HostRequest(NamedTuple):
    """One recorded request: an outermost host span (:meth:`SpanTracker.span`)
    and every host span inside it.

    ``enter_s``/``exit_s`` are on the event-log clock (:meth:`EventLog.now`).
    ``phases`` maps each span name met in the request to the summed self
    time of its spans (a span's length less the spans directly inside it),
    the request's own name included: the values sum to ``exit_s - enter_s``.
    ``spans`` counts the request and every span inside it, ``host_reads``
    the reads of tensor values to the host made in it, ``rows_batched`` the
    state bundles whose per-row states took the batched-rows form in it,
    ``merged_leaves`` the state leaves that took the merge in it.
    ``profiled`` says a ``torch.profiler`` was active, which slows the host.
    """

    request: str
    name: str
    enter_s: float
    exit_s: float
    thread: int
    profiled: bool
    spans: int
    host_reads: int
    phases: Dict[str, float]
    attrs: Dict[str, Any]
    rows_batched: int
    merged_leaves: int


class _NullSpan:
    """The shared context of a span that neither records nor opens a range."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def note(self, **attrs: Any) -> None:
        """Add attributes to the span (a no-op here)."""


_NULL_SPAN = _NullSpan()


class _Span(_NullSpan):
    """An open host span: a profiler range while a profiler runs, and a part
    of its request in ``tracker``'s host ring when ``tracker`` is given."""

    __slots__ = ("_tracker", "_range", "name", "attrs", "profiled", "enter_s", "inner_s", "request")

    def __init__(self, tracker: Optional["SpanTracker"], name: str, attrs: Dict[str, Any]) -> None:
        self._tracker = tracker
        self.name = name
        self.attrs = attrs
        self.profiled = bool(torch._C._autograd._profiler_enabled())
        self._range = compiled_scope(name) if self.profiled else None

    def __enter__(self) -> "_Span":
        if self._range is not None:
            self._range.__enter__()
        if self._tracker is not None:
            self._tracker._open_host(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._tracker is not None:
            self._tracker._close_host(self)
        if self._range is not None:
            self._range.__exit__(*exc)

    def note(self, **attrs: Any) -> None:
        """Add attributes to the span (kept on a request's record)."""
        self.attrs = {**self.attrs, **attrs}


class _Request:
    """What a request gathers while it is open."""

    __slots__ = ("span_id", "spans", "host_reads", "rows_batched", "merged_leaves", "phases", "profiled")

    def __init__(self, span_id: str, profiled: bool) -> None:
        self.span_id = span_id
        self.spans = 1
        self.host_reads = 0
        self.rows_batched = 0
        self.merged_leaves = 0
        self.phases: Dict[str, float] = {}
        self.profiled = profiled


class _HostStack(threading.local):
    """Per thread: the open host spans, innermost last."""

    def __init__(self) -> None:
        self.open: List[_Span] = []


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
        self._spans: "deque[CollectiveSpan]" = deque(maxlen=self._capacity)
        self._seq: Dict[Tuple[int, str, str, str], int] = {}
        self._recorded = 0
        self._dropped = 0
        self._by_kind: Dict[str, int] = {}
        self._fleet_report: Optional[Dict[str, Any]] = None
        self._host: "deque[Tuple[Any, ...]]" = deque(maxlen=DEFAULT_HOST_CAPACITY)
        self._host_seq: Dict[str, "itertools.count[int]"] = {}
        self._host_recorded = 0
        self._host_dropped = 0
        self._host_reads = 0
        self._rows_batched = 0
        self._merged_leaves = 0
        self._stack = _HostStack()

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
            if len(self._spans) == self._capacity:
                self._dropped += 1
            self._spans.append(record)
            self._recorded += 1
            self._by_kind[span.kind] = self._by_kind.get(span.kind, 0) + 1
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

    # -- host spans -----------------------------------------------------------

    def span(self, name: str, **attrs: Any) -> _NullSpan:
        """A host span ``name`` as a context manager: ``with TRACER.span(
        "keyed.update", path="eager") as s: ...; s.note(rows=n)``.

        Enabled, it is a request of its own (a :class:`HostRequest` on exit)
        or, inside one on the same thread, a part of it; under an active
        ``torch.profiler`` it is also a ``metrics/<name>`` range. Inside a
        compiled program's run (a capture on the card, every call on the
        CPU) it records nothing. Disabled with no profiler running, it is
        one shared null context, after two flag reads."""
        if self._enabled:
            return _Span(self, name, attrs)
        if torch._C._autograd._profiler_enabled():
            return _Span(None, name, attrs)
        return _NULL_SPAN

    def phase(self, name: str) -> _NullSpan:
        """A host span ``name`` that is only ever a part of a request: inside
        a request open on this thread, and not directly inside a span of its
        own name, it is :meth:`span`; anywhere else (no request open, the
        tracker disabled, which with a profiler running too opens no range)
        it is the shared null context."""
        if self._enabled:
            stack = self._stack.open
            if stack and stack[-1].name != name:
                return _Span(self, name, {})
        return _NULL_SPAN

    def _open_host(self, span: _Span) -> None:
        if _in_compiled_program():
            span._tracker = None
            return
        stack = self._stack.open
        if stack:
            request = stack[0].request
            request.spans += 1
            request.profiled = request.profiled or span.profiled
        else:
            # one sequence a name; next() on a count is atomic
            seq = self._host_seq.get(span.name)
            if seq is None:
                seq = self._host_seq.setdefault(span.name, itertools.count())
            request = _Request(f"{span.name}|{next(seq)}", span.profiled)
        if span.name == HOST_READ:
            request.host_reads += 1
        span.request = request
        span.inner_s = 0.0
        stack.append(span)
        span.enter_s = self._log.now()

    def _close_host(self, span: _Span) -> None:
        exit_s = self._log.now()
        stack = self._stack.open
        stack.pop()  # a with block's span: the innermost open one
        length = exit_s - span.enter_s
        request = span.request
        phases = request.phases
        phases[span.name] = phases.get(span.name, 0.0) + length - span.inner_s
        if stack:
            stack[-1].inner_s += length
            return
        record = (request.span_id, span.name, span.enter_s, exit_s, threading.get_ident(), request.profiled,
                  request.spans, request.host_reads, phases, span.attrs, request.rows_batched,
                  request.merged_leaves)
        with self._lock:
            if len(self._host) == self._host.maxlen:
                self._host_dropped += 1
            self._host.append(record)
            self._host_recorded += 1
            self._host_reads += request.host_reads
            self._rows_batched += request.rows_batched
            self._merged_leaves += request.merged_leaves

    def note_rows_batched(self) -> None:
        """Count one state bundle whose per-row states took the batched-rows
        form (:func:`~metrics_tpu_torch.utilities.stacked.row_states`) in the
        request open on this thread. Outside a request, inside a compiled
        program's run or disabled, it records nothing."""
        if self._enabled and not _in_compiled_program():
            stack = self._stack.open
            if stack:
                stack[0].request.rows_batched += 1

    def note_merged_leaves(self, leaves: int) -> None:
        """Count ``leaves`` state leaves that took the merge
        (:func:`~metrics_tpu_torch.kernels.segment_scatter.segment_merge_cuda`)
        in the request open on this thread. Outside a request, inside a
        compiled program's run or disabled, it records nothing."""
        if self._enabled and not _in_compiled_program():
            stack = self._stack.open
            if stack:
                stack[0].request.merged_leaves += leaves

    def host_records(self) -> List[HostRequest]:
        """A consistent copy of the retained requests, in the order they
        closed."""
        with self._lock:
            records = list(self._host)
        return [HostRequest._make(r) for r in records]

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
                "host": {
                    "capacity": self._host.maxlen,
                    "size": len(self._host),
                    "recorded": self._host_recorded,
                    "dropped": self._host_dropped,
                    "host_reads": self._host_reads,
                    "rows_batched": self._rows_batched,
                    "merged_leaves": self._merged_leaves,
                },
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
            self._host.clear()
            self._host_seq.clear()
            self._host_recorded = 0
            self._host_dropped = 0
            self._host_reads = 0
            self._rows_batched = 0
            self._merged_leaves = 0


#: the process-global span tracker every instrumented collective feeds
TRACER = SpanTracker()


def collective_span(kind: str, *, group: str = "all", bucket: str = "-", **payload: Any):
    """Scope a collective span on the global tracker (see
    :meth:`SpanTracker.collective_span`)."""
    return TRACER.collective_span(kind, group=group, bucket=bucket, **payload)


def span(name: str, **attrs: Any) -> _NullSpan:
    """A host span on the global tracker (see :meth:`SpanTracker.span`)."""
    return TRACER.span(name, **attrs)


_TRACE_STATE: Any = None


def _in_compiled_program() -> bool:
    """True while a compiled dispatch runs its program on this thread
    (:class:`~metrics_tpu_torch.utilities.data.trace_scope`, looked up on
    first use: the utilities import this package)."""
    global _TRACE_STATE
    if _TRACE_STATE is None:
        from metrics_tpu_torch.utilities.data import _TRACE

        _TRACE_STATE = _TRACE
    return _TRACE_STATE.active


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
    from metrics_tpu_torch.utilities.data import to_host

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
        gathered = to_host(_dist._all_gather(reading, None), numpy=True).reshape(-1)
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
    from metrics_tpu_torch.utilities.data import to_host

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
    blobs = [json.loads(bytes(to_host(buf, numpy=True)).decode("utf-8")) for buf in gathered]

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
