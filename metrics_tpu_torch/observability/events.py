"""Structured event log: the step-correlated timeline behind the telemetry.

Counterpart of ``metrics_tpu/observability/events.py``, copied. The
registry (:mod:`~metrics_tpu_torch.observability.registry`) answers "how
many times / how long in total"; this module answers "**when**, relative to
the training step". Every instrumented point of the package appends a typed
:class:`Event` — ``update`` / ``forward`` / ``compute`` / ``sync`` /
``compile`` — carrying the user's step counter, an interval on one shared
host clock, the owning metric's telemetry key and a JSON-serializable
payload. The log is bounded (old events are evicted, with an eviction
counter, so a serving loop can run forever), thread-safe and host-side
only. The intervals are host time: an ``update`` on the card returns once
its work is enqueued, so its event spans the enqueueing, not the card's
work.

Step correlation is explicit — the library cannot guess the trainer's step::

    from metrics_tpu_torch import observability

    for step, batch in enumerate(loader):
        with observability.step_context(step):
            acc(preds, target)        # events carry step=<step>

or imperatively via ``observability.set_step(step)``. Events recorded outside
any step context carry ``step=None``. :meth:`EventLog.summary` is the
compact form that joins ``observability.snapshot()``. ``EVENT_KINDS`` is the
JAX package's closed set, kept whole so that the two logs agree on it,
though the port records only some of the kinds so far.
"""
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

#: the closed set of event kinds (the JAX package's); ``compile`` marks a
#: one-time layout step (the keyed collection's build), the others name the
#: lifecycle call or plane that records them
EVENT_KINDS = (
    "update", "forward", "compute", "sync", "retrace", "health", "compile",
    "tenant_report", "straggler", "serving", "durability", "resilience", "slo",
    "profile",
)

#: default bound on retained events; ~100 bytes each, so the default log
#: tops out near half a megabyte of host memory
DEFAULT_CAPACITY = 4096


class Event(NamedTuple):
    """One timeline record. ``ts_s`` is seconds since the log's epoch on the
    monotonic clock shared by every event (so intervals nest correctly);
    ``dur_s`` is 0.0 for instantaneous events (retrace, trace-time sync,
    health flags)."""

    seq: int
    kind: str
    metric: Optional[str]
    step: Optional[int]
    ts_s: float
    dur_s: float
    payload: Dict[str, Any]


class EventLog:
    """Bounded, thread-safe, step-correlated event log.

    One process-global instance (:data:`EVENTS`) backs the library;
    private instances are supported for tests. All state lives under a
    ``threading.Lock``; call sites gate on the lock-free :attr:`enabled`
    read, so a disabled log costs one attribute read per call site.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True) -> None:
        if capacity < 1:
            raise ValueError(f"event log capacity must be >= 1, got {capacity}")
        self._lock = threading.Lock()
        self._enabled = enabled
        self._capacity = int(capacity)
        # unbounded deque + explicit popleft (not maxlen=) so evictions are
        # counted, and appends/evictions stay O(1) at capacity; each entry
        # holds an Event's fields as a plain tuple
        self._events: "deque[tuple]" = deque()
        self._epoch = time.perf_counter()
        self._epoch_unix = time.time()
        self._seq = 0
        self._dropped = 0
        self._high_water = 0
        self._step: Optional[int] = None
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

    def set_capacity(self, n: int) -> None:
        """Re-bound the log to the newest ``n`` events."""
        if n < 1:
            raise ValueError(f"event log capacity must be >= 1, got {n}")
        with self._lock:
            self._capacity = int(n)
            while len(self._events) > self._capacity:
                self._events.popleft()
                self._dropped += 1

    # -- step correlation ---------------------------------------------------

    def set_step(self, n: Optional[int]) -> None:
        """Tag subsequent events with user step ``n`` (``None`` untags)."""
        self._step = None if n is None else int(n)

    def get_step(self) -> Optional[int]:
        return self._step

    @contextmanager
    def step_context(self, n: Optional[int] = None) -> Iterator[int]:
        """Scope a step tag: events inside the block carry step ``n`` (one
        past the current step when omitted); the previous tag is restored on
        exit, so nested loops and interleaved eval phases stay correct."""
        prev = self._step
        if n is None:
            n = 0 if prev is None else prev + 1
        self.set_step(n)
        try:
            yield n
        finally:
            self._step = prev

    # -- recording ----------------------------------------------------------

    def record(
        self,
        kind: str,
        metric: Optional[str] = None,
        *,
        dur_s: float = 0.0,
        t_start: Optional[float] = None,
        **payload: Any,
    ) -> None:
        """Append one event. ``t_start`` (a ``time.perf_counter()`` value
        captured by the caller before the timed section) pins the interval's
        true start; without it the interval is anchored ``dur_s`` before now.
        ``payload`` must be JSON-serializable — it rides the snapshot and the
        exported timeline verbatim."""
        if not self._enabled:
            return
        ts = (t_start if t_start is not None else time.perf_counter() - dur_s) - self._epoch
        with self._lock:
            seq = self._seq
            self._seq = seq + 1
            events = self._events
            # a plain tuple here, the Event when read: building the named
            # tuple costs more than the rest of the append
            events.append((seq, kind, metric, self._step, ts, float(dur_s), payload))
            by_kind = self._by_kind
            by_kind[kind] = by_kind.get(kind, 0) + 1
            size = len(events)
            if size > self._capacity:
                events.popleft()
                self._dropped += 1
            elif size > self._high_water:
                self._high_water = size

    # -- reading ------------------------------------------------------------

    def events(self) -> List[Event]:
        """A consistent copy of the retained events, oldest first."""
        with self._lock:
            return [Event._make(e) for e in self._events]

    @property
    def epoch_unix(self) -> float:
        """Wall-clock (``time.time()``) instant of the log's ``ts_s=0``."""
        return self._epoch_unix

    def now(self) -> float:
        """The current instant on the log's clock (seconds since its epoch)
        — the shared timebase event ``ts_s`` and collective-span timestamps
        (:mod:`~metrics_tpu_torch.observability.tracing`) are recorded on."""
        return time.perf_counter() - self._epoch

    def summary(self) -> Dict[str, Any]:
        """Compact JSON view for ``snapshot()``: totals per kind, the
        retention high-water mark, and eviction pressure."""
        with self._lock:
            return {
                "enabled": self._enabled,
                "capacity": self._capacity,
                "size": len(self._events),
                "high_water": self._high_water,
                "recorded_total": self._seq,
                "dropped": self._dropped,
                "step": self._step,
                "by_kind": dict(self._by_kind),
            }

    def clear(self) -> None:
        """Drop every retained event and zero the counters (the step tag and
        capacity survive: a scrape-and-reset loop keeps its correlation)."""
        with self._lock:
            self._events.clear()
            self._seq = 0
            self._dropped = 0
            self._high_water = 0
            self._by_kind.clear()
            self._epoch = time.perf_counter()
            self._epoch_unix = time.time()


#: the process-global event log every instrumented call site feeds
EVENTS = EventLog()


def set_step(n: Optional[int]) -> None:
    """Tag subsequent events with user step ``n`` (see :class:`EventLog`)."""
    EVENTS.set_step(n)


def get_step() -> Optional[int]:
    """The current step tag (``None`` outside any step context)."""
    return EVENTS.get_step()


def step_context(n: Optional[int] = None):
    """Scope a step tag on the global log (see :meth:`EventLog.step_context`)."""
    return EVENTS.step_context(n)
