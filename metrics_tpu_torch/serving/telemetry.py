"""The ``serving.*`` telemetry family: exact accounting of the serving plane.

Counterpart of ``metrics_tpu/serving/telemetry.py``. One process-global
:class:`ServingStats` ledger records every admission outcome (admitted /
shed, by reason), every flush (by trigger), every dispatched row and every
scheduler read outcome (cache hit / miss / stale serve / refresh). It
surfaces as ``observability.snapshot()["serving"]`` (``{}`` until the first
queue is built), the ``metrics_tpu_serving_*`` Prometheus series, and the
log2 histograms below: ``serving_ingest_seconds`` (admission to dispatch
complete) with its two parts ``serving_queue_wait_seconds`` (submit to flush
start) and ``serving_dispatch_seconds`` (flush start to dispatch complete),
``serving_flush_seconds``, ``serving_queue_depth`` (unit ``count``),
``serving_read_staleness_seconds`` and the staging series.

All of it is host-side bookkeeping behind the lock-free
``TELEMETRY.enabled`` gate. On the card a dispatch returns once its work is
enqueued, so the dispatch and ingest times are host times up to the enqueue
of the keyed update, not its completion on the device.
"""
import threading
import weakref
from typing import Any, Dict

import numpy as np

from metrics_tpu_torch.observability.histogram import HISTOGRAMS
from metrics_tpu_torch.observability.registry import TELEMETRY

__all__ = [
    "SERVING_STATS",
    "ServingStats",
    "observe_dispatch_latency",
    "observe_flush",
    "observe_ingest",
    "observe_queue_depth",
    "observe_queue_wait",
    "observe_read_staleness",
    "observe_staging_fill",
    "observe_staging_occupancy",
    "observe_staging_overlap",
    "summary",
]

#: canonical fast-path histogram series of the serving plane
INGEST_SECONDS = "serving_ingest_seconds"
QUEUE_WAIT_SECONDS = "serving_queue_wait_seconds"
DISPATCH_SECONDS = "serving_dispatch_seconds"
FLUSH_SECONDS = "serving_flush_seconds"
QUEUE_DEPTH = "serving_queue_depth"
READ_STALENESS_SECONDS = "serving_read_staleness_seconds"
#: the staged flush path: per-cohort stage time (ring to slot fill,
#: quarantine, pad, H2D enqueue), the part of a PREFETCHED cohort's stage
#: that ran under a concurrent dispatch, and slot-pool occupancy
STAGING_FILL_SECONDS = "serving_staging_fill_seconds"
STAGING_OVERLAP_SECONDS = "serving_staging_overlap_seconds"
STAGING_OCCUPANCY = "serving_staging_occupancy"


def observe_ingest(seconds: np.ndarray, policy: str) -> None:
    """Admission-to-dispatch-complete wall time of each row of a flush (one
    value per row, observed in bulk)."""
    HISTOGRAMS.observe_many(INGEST_SECONDS, seconds, unit="s", policy=policy)


def observe_queue_wait(seconds: np.ndarray, policy: str) -> None:
    """Submit → flush-start wall time of each row: the host-queue component
    of :data:`INGEST_SECONDS`."""
    HISTOGRAMS.observe_many(QUEUE_WAIT_SECONDS, seconds, unit="s", policy=policy)


def observe_dispatch_latency(seconds: np.ndarray, policy: str) -> None:
    """Flush-start → dispatch-return wall time of one row's cohort: the
    dispatch component of :data:`INGEST_SECONDS` (row-weighted — every row
    in a cohort records the cohort's dispatch time, so counts line up with
    the ingest series). On the card the dispatch returns once enqueued."""
    HISTOGRAMS.observe_many(DISPATCH_SECONDS, seconds, unit="s", policy=policy)


def observe_read_staleness(seconds: float, outcome: str) -> None:
    """Cache-generation age a scheduler read observed (0 for fresh hits;
    the served age for stale serves)."""
    HISTOGRAMS.observe(READ_STALENESS_SECONDS, seconds, unit="s", outcome=outcome)


def observe_flush(seconds: float, trigger: str) -> None:
    """One coalesced dispatch's wall time, labeled by what triggered it
    (``size`` / ``deadline`` / ``manual`` / ``close``)."""
    HISTOGRAMS.observe(FLUSH_SECONDS, seconds, unit="s", trigger=trigger)


def observe_queue_depth(rows: int) -> None:
    """Rows resident in the queue at flush time (unit ``count``)."""
    HISTOGRAMS.observe(QUEUE_DEPTH, float(rows), unit="count")


def observe_staging_fill(seconds: float) -> None:
    """One staged cohort's total stage time: ring→slot slice copy,
    vectorized quarantine scan, in-place pad fold, and the H2D transfer."""
    HISTOGRAMS.observe(STAGING_FILL_SECONDS, seconds, unit="s")


def observe_staging_overlap(seconds: float) -> None:
    """The portion of a PREFETCHED cohort's stage window that ran while the
    previous cohort's dispatch was in flight — the double-buffer's yield."""
    HISTOGRAMS.observe(STAGING_OVERLAP_SECONDS, seconds, unit="s")


def observe_staging_occupancy(slots: int) -> None:
    """Staging slots in use at stage-complete time (unit ``count``)."""
    HISTOGRAMS.observe(STAGING_OCCUPANCY, float(slots), unit="count")


class ServingStats:
    """Thread-safe counters for the serving plane (one process-global
    instance, :data:`SERVING_STATS`; private instances supported for
    tests). ``touched`` stays False until the first queue registers, so an
    idle process's snapshot omits the section entirely."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._touched = False
        self._queues: "weakref.WeakSet" = weakref.WeakSet()
        self._counters: Dict[str, int] = {
            "submitted_rows": 0,
            "admitted_rows": 0,
            "shed_rows": 0,
            "dispatched_rows": 0,
            "flushes": 0,
            "dispatch_errors": 0,
            "reads": 0,
            "cache_hits": 0,
            "cache_misses": 0,
            "stale_serves": 0,
            "tenant_cache_hits": 0,
            "refreshes": 0,
            "coalesced_refreshes": 0,
            "generation_bumps": 0,
            "staged_cohorts": 0,
            "prefetched_cohorts": 0,
        }
        self._shed_by_reason: Dict[str, int] = {}
        self._flushes_by_trigger: Dict[str, int] = {}
        self._depth_high_water = 0

    # -- recording ----------------------------------------------------------

    def register_queue(self, queue: Any) -> None:
        with self._lock:
            self._touched = True
            self._queues.add(queue)

    def inc(self, counter: str, n: int = 1) -> None:
        if not TELEMETRY.enabled:
            return
        with self._lock:
            self._touched = True
            self._counters[counter] = self._counters.get(counter, 0) + int(n)

    def shed(self, reason: str, n: int) -> None:
        """One shed decision: ``n`` rows under ``reason`` — the per-reason
        split and the total move together, so the accounting can never
        drift."""
        if not TELEMETRY.enabled or n <= 0:
            return
        with self._lock:
            self._touched = True
            self._counters["shed_rows"] += int(n)
            self._shed_by_reason[reason] = self._shed_by_reason.get(reason, 0) + int(n)

    def flush(self, trigger: str, rows: int, depth: int) -> None:
        if not TELEMETRY.enabled:
            return
        with self._lock:
            self._touched = True
            self._counters["flushes"] += 1
            self._counters["dispatched_rows"] += int(rows)
            self._flushes_by_trigger[trigger] = (
                self._flushes_by_trigger.get(trigger, 0) + 1
            )
            if depth > self._depth_high_water:
                self._depth_high_water = int(depth)

    # -- reading ------------------------------------------------------------

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def summary(self) -> Dict[str, Any]:
        """The ``snapshot()["serving"]`` section (``{}`` when untouched)."""
        with self._lock:
            if not self._touched:
                return {}
            queues = list(self._queues)
            out = {
                "queues": len(queues),
                "depth": 0,
                "depth_high_water": self._depth_high_water,
                **dict(self._counters),
                "shed_by_reason": dict(self._shed_by_reason),
                "flushes_by_trigger": dict(self._flushes_by_trigger),
            }
        # depths are read OUTSIDE the stats lock: a queue records stats while
        # holding its own condition variable, so nesting the other way here
        # would be an ABBA deadlock
        depth = 0
        for q in queues:
            try:
                depth += q.depth()
            except Exception:  # pragma: no cover - a closing queue
                pass
        out["depth"] = depth
        return out

    def reset(self) -> None:
        """Zero every counter (live queues stay registered — their depths
        keep reporting)."""
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0
            self._shed_by_reason.clear()
            self._flushes_by_trigger.clear()
            self._depth_high_water = 0


#: the process-global serving ledger
SERVING_STATS = ServingStats()


def summary() -> Dict[str, Any]:
    """Module-level accessor ``observability.snapshot()`` reads."""
    return SERVING_STATS.summary()
