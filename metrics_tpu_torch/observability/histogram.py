"""Fixed-bucket log2 histograms for the host-side hot path.

Counterpart of ``metrics_tpu/observability/histogram.py``, copied: it
imports numpy only. The registry's timers
(:class:`~metrics_tpu_torch.observability.registry._Histogram`) answer "how
long do calls take" at 6 coarse decades; these are the fast-path
instrument: dispatch wall times, sync round trips and gather payload sizes.

* **Host-side only.** Observations happen at instrumented call sites gated
  on the lock-free ``TELEMETRY.enabled`` read, and record host clocks: a
  ``dispatch_seconds`` value is the time to enqueue work on the card, not
  the card's time (no call site synchronizes to make it so).
* **No allocation, no lock contention on the fast path.**
  :meth:`Log2Histogram.observe` is one ``math.frexp`` (the value's binary
  exponent IS the bucket index) plus three in-place writes into preallocated
  numpy buffers. There is no lock: under concurrent writers counts may
  under-tally by the races lost (never corrupt, never raise). Series
  *creation* takes a lock once; call sites hit a plain dict read afterwards.
* **Mergeable.** Bucket layouts are fixed per unit (``"s"`` / ``"bytes"`` /
  ``"count"``), so merging two processes' histograms is an elementwise
  bucket sum.

:meth:`Log2Histogram.to_dict` carries the bucket table plus
``p50``/``p95``/``p99`` estimates into ``observability.snapshot()`` (under
``histograms``); the Prometheus renderer emits each series in the histogram
exposition form (cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``).

**Windowed views.** Every histogram also keeps a ring of per-epoch bucket
*deltas* (``WINDOW_RING_EPOCHS`` epochs): :meth:`HistogramRegistry.rotate`
snapshots ``current - previous`` bucket counts into the ring, and
:meth:`Log2Histogram.window` sums the newest epochs (plus the in-progress
partial epoch) into a :class:`HistogramWindow` with its own p50/p95/p99.
``observe`` itself does not touch the ring.
"""
import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: binary-exponent range of the latency buckets: upper bounds 2^-20 s (~1 µs)
#: .. 2^2 s (4 s), +inf implicit — 23 finite buckets spanning µs-dispatches to
#: multi-second stragglers at a fixed 2x resolution
LATENCY_EXP_RANGE = (-20, 2)
#: binary-exponent range of the size buckets: upper bounds 2^6 (64 B) ..
#: 2^30 (1 GiB), +inf implicit
SIZE_EXP_RANGE = (6, 30)
#: binary-exponent range of the count buckets (queue depths, batch sizes):
#: upper bounds 2^0 (1) .. 2^20 (~1M), +inf implicit
COUNT_EXP_RANGE = (0, 20)

#: bucket layout per unit — every histogram of one unit shares a layout, so
#: cross-process aggregation is an elementwise bucket sum
UNIT_EXP_RANGES = {
    "s": LATENCY_EXP_RANGE,
    "bytes": SIZE_EXP_RANGE,
    "count": COUNT_EXP_RANGE,
}

#: ring capacity in epochs — with the default 1 s epoch the longest windowed
#: view spans ~64 s, enough for a fast (1 min) SRE burn-rate window
WINDOW_RING_EPOCHS = 64
#: default epoch length between :meth:`HistogramRegistry.rotate` ticks
DEFAULT_WINDOW_EPOCH_S = 1.0
#: default sliding-window length the snapshot view reports
DEFAULT_WINDOW_S = 30.0


def _percentile_from(counts: np.ndarray, min_exp: int, q: float) -> float:
    """Percentile estimate over a bucket-count array (shared by the live
    histogram, window views, and the aggregation recompute): linear
    interpolation inside the covering bucket, clamped at the last finite
    bound when the rank lands in ``+inf``. 0.0 when empty."""
    total = int(counts.sum())
    if total == 0:
        return 0.0
    rank = q / 100.0 * total
    cum = 0
    for i in range(counts.shape[0]):
        prev = cum
        cum += int(counts[i])
        if cum >= rank and cum > 0:
            hi = 2.0 ** (min_exp + i)
            if i == counts.shape[0] - 1:  # +inf bucket: clamp
                return 2.0 ** (min_exp + i - 1)
            lo = 2.0 ** (min_exp + i - 1) if i > 0 else 0.0
            inside = int(counts[i])
            frac = (rank - prev) / inside if inside else 1.0
            return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
    return 2.0 ** (min_exp + counts.shape[0] - 2)  # pragma: no cover


def _bucket_table(counts: np.ndarray, min_exp: int) -> Dict[str, int]:
    """The JSON bucket table (``le_<bound>`` -> count, then ``le_inf``)."""
    buckets = {}
    for i in range(counts.shape[0] - 1):
        bound = 2.0 ** (min_exp + i)
        buckets[f"le_{bound:.9g}"] = int(counts[i])
    buckets["le_inf"] = int(counts[-1])
    return buckets


class HistogramWindow:
    """A sliding-window view over a :class:`Log2Histogram`: the elementwise
    sum of the newest ring epochs plus the in-progress partial epoch.

    Immutable once built; ``count`` is derived from the bucket sum so the
    triple (buckets, count, sum) is internally consistent even when built
    while writers race (see :meth:`Log2Histogram.window`)."""

    __slots__ = ("unit", "seconds", "epochs", "_min_exp", "_counts", "_sum")

    def __init__(
        self,
        unit: str,
        min_exp: int,
        counts: np.ndarray,
        sum_: float,
        seconds: float,
        epochs: int,
    ) -> None:
        self.unit = unit
        self.seconds = float(seconds)
        self.epochs = int(epochs)
        self._min_exp = min_exp
        self._counts = counts
        self._sum = float(sum_)

    @property
    def count(self) -> int:
        return int(self._counts.sum())

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min_exp(self) -> int:
        return self._min_exp

    def bucket_counts(self) -> np.ndarray:
        return self._counts.copy()

    def percentile(self, q: float) -> float:
        return _percentile_from(self._counts, self._min_exp, q)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seconds": round(self.seconds, 9),
            "epochs": self.epochs,
            "count": self.count,
            "sum": round(self._sum, 9),
            "buckets": _bucket_table(self._counts, self._min_exp),
            "p50": round(self.percentile(50.0), 9),
            "p95": round(self.percentile(95.0), 9),
            "p99": round(self.percentile(99.0), 9),
        }


class Log2Histogram:
    """Preallocated fixed-bucket histogram with power-of-two bounds.

    Bucket ``i`` counts observations in ``(2^(min_exp+i-1), 2^(min_exp+i)]``
    (Prometheus ``le`` semantics on the upper bound); the first bucket
    additionally absorbs everything at or below its bound, the last
    (``+inf``) everything above ``2^max_exp``. ``observe`` never allocates
    and never locks.
    """

    __slots__ = (
        "unit",
        "_min_exp",
        "_counts",
        "_totals",
        "_win_epoch_s",
        "_win_prev_counts",
        "_win_prev_sum",
        "_win_ring",
    )

    def __init__(self, unit: str = "s", window_epoch_s: float = DEFAULT_WINDOW_EPOCH_S) -> None:
        if unit not in UNIT_EXP_RANGES:
            raise ValueError(f"unknown histogram unit {unit!r}; known: {sorted(UNIT_EXP_RANGES)}")
        self.unit = unit
        min_exp, max_exp = UNIT_EXP_RANGES[unit]
        self._min_exp = min_exp
        # finite buckets + the +inf bucket, preallocated once
        self._counts = np.zeros(max_exp - min_exp + 2, dtype=np.int64)
        # [count, sum] — kept in one buffer so observe touches two arrays total
        self._totals = np.zeros(2, dtype=np.float64)
        # windowing state: previous rotation snapshot + ring of epoch deltas.
        # Touched only by rotate()/window() — never by observe().
        self._win_epoch_s = float(window_epoch_s)
        self._win_prev_counts = np.zeros_like(self._counts)
        self._win_prev_sum = 0.0
        self._win_ring: deque = deque(maxlen=WINDOW_RING_EPOCHS)

    # -- recording (the fast path) ------------------------------------------

    def observe(self, value: float) -> None:
        value = float(value)
        if value > 0.0:
            # frexp: value = m * 2^e with m in [0.5, 1) -> the smallest upper
            # bound holding value is 2^e, except an exact power of two
            # (m == 0.5) belongs to its own bound 2^(e-1) ("le" semantics)
            m, e = math.frexp(value)
            if m == 0.5:
                e -= 1
            idx = e - self._min_exp
            if idx < 0:
                idx = 0
            elif idx >= self._counts.shape[0]:
                idx = self._counts.shape[0] - 1
        else:
            idx = 0
        self._counts[idx] += 1
        self._totals[0] += 1.0
        self._totals[1] += value

    def observe_many(self, values: np.ndarray) -> None:
        """:meth:`observe` of every value of ``values`` at once: the same
        buckets by one ``np.frexp`` and one ``np.bincount`` (the sum adds in
        numpy's order)."""
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        if values.size == 0:
            return
        m, e = np.frexp(values)
        idx = np.clip(e - (m == 0.5) - self._min_exp, 0, self._counts.shape[0] - 1)
        idx[~(values > 0.0)] = 0
        self._counts += np.bincount(idx, minlength=self._counts.shape[0])
        self._totals[0] += values.size
        self._totals[1] += values.sum()

    # -- reading -------------------------------------------------------------

    @property
    def count(self) -> int:
        return int(self._totals[0])

    @property
    def sum(self) -> float:
        return float(self._totals[1])

    def bounds(self) -> Tuple[float, ...]:
        """Finite bucket upper bounds (the +inf bucket is implicit last)."""
        return tuple(
            2.0 ** (self._min_exp + i) for i in range(self._counts.shape[0] - 1)
        )

    def _consistent_read(self) -> Tuple[np.ndarray, float]:
        """A tear-resistant ``(bucket copy, sum)`` pair under racing writers.

        ``observe`` writes the bucket first and the sum last, so reading the
        sum *before* copying the buckets guarantees every observation counted
        in the returned sum is also present in the returned buckets. Deriving
        the count from the bucket copy (rather than the separately-raced
        ``_totals[0]``) then makes the (buckets, count, sum) triple internally
        consistent: ``count == sum(buckets)`` exactly, and ``sum`` covers a
        subset of those counted observations."""
        sum_ = float(self._totals[1])
        return self._counts.copy(), sum_

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-th percentile (``q`` in [0, 100]) from the
        buckets: linear interpolation inside the covering bucket, its upper
        bound when the rank lands in ``+inf``. 0.0 when empty."""
        counts, _ = self._consistent_read()
        return _percentile_from(counts, self._min_exp, q)

    def bucket_counts(self) -> np.ndarray:
        """The raw per-bucket counts (finite buckets then +inf) — the
        sum-reducible leaf the aggregation pytree ships."""
        return self._counts.copy()

    # -- windowing -----------------------------------------------------------

    def rotate(self) -> None:
        """Close the in-progress epoch: push the delta since the previous
        rotation onto the ring and advance the rotation snapshot. Driven by
        :meth:`HistogramRegistry.rotate`; never called from the hot path."""
        counts, sum_ = self._consistent_read()
        self._win_ring.append((counts - self._win_prev_counts, sum_ - self._win_prev_sum))
        self._win_prev_counts = counts
        self._win_prev_sum = sum_

    def window(self, seconds: float) -> HistogramWindow:
        """A sliding-window view spanning roughly the last ``seconds``: the
        elementwise sum of the newest ``ceil(seconds / epoch)`` ring deltas
        plus the in-progress partial epoch. The covered span is quantised to
        whole epochs (plus the partial), so a window slightly wider than
        requested is normal; a ring shorter than the request covers what it
        has."""
        epochs = max(1, int(math.ceil(float(seconds) / self._win_epoch_s)))
        counts, sum_ = self._consistent_read()
        win_counts = counts - self._win_prev_counts  # in-progress partial epoch
        win_sum = sum_ - self._win_prev_sum
        taken = 0
        for delta_counts, delta_sum in list(self._win_ring)[::-1]:
            if taken >= epochs:
                break
            win_counts = win_counts + delta_counts
            win_sum += delta_sum
            taken += 1
        return HistogramWindow(
            self.unit, self._min_exp, win_counts, win_sum, seconds, taken
        )

    def reset_window(self, window_epoch_s: Optional[float] = None) -> None:
        """Drop all window state (and optionally re-epoch); the cumulative
        counts are untouched."""
        if window_epoch_s is not None:
            self._win_epoch_s = float(window_epoch_s)
        self._win_ring.clear()
        counts, sum_ = self._consistent_read()
        self._win_prev_counts = counts
        self._win_prev_sum = sum_

    def merge_counts(self, counts: Any, count: float, sum_: float) -> None:
        """Fold another histogram's raw buckets/totals into this one (the
        aggregation path; layouts are fixed per unit so this is elementwise)."""
        counts = np.asarray(counts, dtype=np.int64)
        if counts.shape != self._counts.shape:
            raise ValueError(
                f"bucket layout mismatch: {counts.shape} vs {self._counts.shape}"
            )
        self._counts += counts
        self._totals[0] += float(count)
        self._totals[1] += float(sum_)

    def to_dict(self, window_seconds: Optional[float] = None) -> Dict[str, Any]:
        """JSON view: bucket table (``le_<bound>`` -> count), totals, and the
        p50/p95/p99 estimates, all derived from one consistent bucket copy
        (count == bucket total even under racing writers). With
        ``window_seconds`` the view additionally carries a ``window``
        sub-dict (the sliding-window buckets and percentiles)."""
        counts, sum_ = self._consistent_read()
        out = {
            "unit": self.unit,
            "count": int(counts.sum()),
            "sum": round(sum_, 9),
            "buckets": _bucket_table(counts, self._min_exp),
            "p50": round(_percentile_from(counts, self._min_exp, 50.0), 9),
            "p95": round(_percentile_from(counts, self._min_exp, 95.0), 9),
            "p99": round(_percentile_from(counts, self._min_exp, 99.0), 9),
        }
        if window_seconds is not None:
            out["window"] = self.window(window_seconds).to_dict()
        return out


def _series_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={labels[k]}" for k in sorted(labels)) + "}"


class HistogramRegistry:
    """Named fast-path histograms (one process-global instance,
    :data:`HISTOGRAMS`).

    Series are keyed ``name{label=value,...}``; creation is locked once per
    series, after which :meth:`observe` is a dict read plus the lock-free
    :meth:`Log2Histogram.observe`. Call sites gate on ``TELEMETRY.enabled``
    (the registry carries no enablement of its own), so a disabled telemetry
    stack skips these entirely.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: Dict[str, Tuple[Log2Histogram, Dict[str, str], str]] = {}
        self._win_epoch_s = DEFAULT_WINDOW_EPOCH_S
        self.window_seconds = DEFAULT_WINDOW_S
        self._win_last_rotate: Optional[float] = None
        self._win_rotations = 0

    def get(self, name: str, unit: str = "s", **labels: str) -> Log2Histogram:
        """The series' histogram, created (under the lock) on first use."""
        key = _series_key(name, labels)
        entry = self._series.get(key)
        if entry is None:
            with self._lock:
                entry = self._series.get(key)
                if entry is None:
                    entry = (
                        Log2Histogram(unit, window_epoch_s=self._win_epoch_s),
                        dict(labels),
                        name,
                    )
                    self._series[key] = entry
        return entry[0]

    def observe(self, name: str, value: float, unit: str = "s", **labels: str) -> None:
        self.get(name, unit=unit, **labels).observe(float(value))

    def observe_many(self, name: str, values: np.ndarray, unit: str = "s", **labels: str) -> None:
        """:meth:`observe` of each of ``values``, in bulk."""
        self.get(name, unit=unit, **labels).observe_many(values)

    # -- windowing -----------------------------------------------------------

    @property
    def window_epoch_s(self) -> float:
        return self._win_epoch_s

    def set_window_epoch(self, epoch_s: float, window_seconds: Optional[float] = None) -> None:
        """Re-epoch the window ring for every series (dropping existing
        window state — the cumulative buckets are untouched) and optionally
        change the default window length :meth:`snapshot` reports."""
        if epoch_s <= 0.0:
            raise ValueError(f"window epoch must be positive, got {epoch_s!r}")
        with self._lock:
            self._win_epoch_s = float(epoch_s)
            if window_seconds is not None:
                self.window_seconds = float(window_seconds)
            self._win_last_rotate = None
            self._win_rotations = 0
            items = list(self._series.values())
        for hist, _, _ in items:
            hist.reset_window(window_epoch_s=epoch_s)

    def rotate(self, now: float) -> int:
        """Advance every series' window ring to ``now`` (a monotonic-clock
        reading): one rotation per elapsed epoch, capped at the ring length
        so a long-idle process catches up in bounded work. Returns the number
        of rotations performed (0 when within the current epoch)."""
        with self._lock:
            if self._win_last_rotate is None:
                self._win_last_rotate = float(now)
                return 0
            elapsed = float(now) - self._win_last_rotate
            if elapsed < self._win_epoch_s:
                return 0
            pending = int(elapsed // self._win_epoch_s)
            self._win_last_rotate += pending * self._win_epoch_s
            pending = min(pending, WINDOW_RING_EPOCHS)
            self._win_rotations += pending
            items = list(self._series.values())
        for hist, _, _ in items:
            # the first rotation absorbs the full delta; extra catch-up
            # rotations push empty epochs so window spans stay honest
            for _ in range(pending):
                hist.rotate()
        return pending

    def series_items(self) -> List[Tuple[str, Log2Histogram, Dict[str, str], str]]:
        """A consistent ``(key, histogram, labels, name)`` listing — the
        selector surface SLO declarations match against."""
        with self._lock:
            items = list(self._series.items())
        return [(key, hist, dict(labels), name) for key, (hist, labels, name) in items]

    def snapshot(self) -> Dict[str, Any]:
        """JSON view keyed by series: bucket tables, totals, percentiles,
        the sliding-window view (``window_seconds`` long), and the series'
        name/labels split back out (for renderers)."""
        out: Dict[str, Any] = {}
        # snapshot iterates a live dict: take a consistent key list first
        with self._lock:
            items = list(self._series.items())
            window_s = self.window_seconds
        for key, (hist, labels, name) in items:
            entry = hist.to_dict(window_seconds=window_s)
            entry["name"] = name
            if labels:
                entry["labels"] = dict(labels)
            out[key] = entry
        return out

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._win_epoch_s = DEFAULT_WINDOW_EPOCH_S
            self.window_seconds = DEFAULT_WINDOW_S
            self._win_last_rotate = None
            self._win_rotations = 0


#: the process-global fast-path histogram registry
HISTOGRAMS = HistogramRegistry()

#: canonical series names the library records (call sites + docs + tests)
DISPATCH_SECONDS = "dispatch_seconds"
SYNC_ROUND_TRIP_SECONDS = "sync_round_trip_seconds"
GATHER_PAYLOAD_BYTES = "gather_payload_bytes"


def observe_dispatch(seconds: float, path: str) -> None:
    """One dispatch's host wall time (``path``: ``keyed_scatter`` for the
    keyed update): the time to enqueue its work, not the card's time."""
    HISTOGRAMS.observe(DISPATCH_SECONDS, seconds, unit="s", path=path)


def observe_sync_round_trip(seconds: float, transport: str = "gather") -> None:
    """One sync transport's full round-trip wall time on the host clock (see
    :func:`~metrics_tpu_torch.utilities.distributed._gather_all_leaves` for
    what a round's time means under NCCL)."""
    HISTOGRAMS.observe(SYNC_ROUND_TRIP_SECONDS, seconds, unit="s", transport=transport)


def observe_gather_payload(nbytes: int) -> None:
    """One eager gather transport's total payload volume."""
    HISTOGRAMS.observe(GATHER_PAYLOAD_BYTES, nbytes, unit="bytes")
