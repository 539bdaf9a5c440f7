"""SLO declarations, windowed burn-rate accounting, and the breach watchdog.

Counterpart of ``metrics_tpu/observability/slo.py`` (a copy: the JAX module
imports no JAX), numpy over the port's
:class:`~metrics_tpu_torch.observability.histogram.HistogramWindow` rings.
The serving plane's telemetry (log2 histograms, serving spans) answers *what
happened*; this module answers the operator question a serving
controller polls: **"is this objective inside its error budget right now,
and how fast is the budget burning?"**. Three pieces:

* :class:`SLO` — a declaration binding a histogram series selector (name +
  label subset, so per-tenant-tier objectives like ``tier=gold`` work
  unchanged) to a target percentile, a latency threshold, and a pair of
  evaluation windows.
* :class:`SLORegistry` — evaluates every declared SLO against the registry's
  **windowed** bucket deltas (:meth:`Log2Histogram.window`): observations
  above the threshold are *bad events*; the burn rate is the classic SRE
  ratio ``(bad/total) / (1 - objective)`` computed over a fast and a slow
  window, and a breach requires **both** to exceed 1 (multi-window alerting —
  the fast window gives detection latency, the slow window suppresses
  one-blip false positives). :meth:`SLORegistry.breaches` is the
  machine-readable hook the controller will consume — evidence only, no
  actuation here.
* :class:`SLOWatchdog` — tick-driven (no background thread touches the hot
  path): each :meth:`SLOWatchdog.tick` rotates the histogram window rings,
  re-evaluates, and emits edge-triggered ``slo`` timeline events on breach /
  recovery transitions.

Everything is evidence the rest of the stack re-exports:
``observability.snapshot()["slo"]`` (mergeable across the fleet via
``MERGE_RULES``), the ``metrics_tpu_slo_*`` Prometheus family, and the
``slo`` events on ``timeline.export``.
"""
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .events import EVENTS
from .histogram import HISTOGRAMS, HistogramRegistry
from .registry import TELEMETRY

#: default fast / slow evaluation windows (seconds) — short enough that the
#: chaos soak detects an injected fault within one fast window, long enough
#: that the slow window suppresses single-blip noise
DEFAULT_FAST_WINDOW_S = 5.0
DEFAULT_SLOW_WINDOW_S = 30.0


def _bad_count(counts: np.ndarray, min_exp: int, threshold: float) -> float:
    """Estimated number of observations strictly above ``threshold`` in a
    log2 bucket array: whole buckets above it count fully, the covering
    bucket contributes a linear fraction (mirroring the percentile
    interpolation so p-estimates and burn rates agree), the ``+inf`` bucket
    is always bad."""
    bad = float(counts[-1])  # +inf bucket
    for i in range(counts.shape[0] - 1):
        n = int(counts[i])
        if n == 0:
            continue
        hi = 2.0 ** (min_exp + i)
        lo = 2.0 ** (min_exp + i - 1) if i > 0 else 0.0
        if threshold >= hi:
            continue  # whole bucket at or below the threshold
        if threshold <= lo:
            bad += n  # whole bucket above
        else:
            bad += n * (hi - threshold) / (hi - lo)
    return bad


class SLO:
    """One service-level objective: ``percentile`` of the matching series
    must stay at or below ``threshold`` for at least ``objective`` of
    observations, judged over a fast and a slow sliding window.

    ``series`` selects histogram series by name; ``labels`` (a subset match)
    narrows to e.g. one tenant tier. ``objective`` defaults to
    ``percentile / 100`` — "p99 <= threshold" and "99% of observations <=
    threshold" are the same statement over a window."""

    __slots__ = (
        "name",
        "series",
        "percentile",
        "threshold",
        "objective",
        "fast_window_s",
        "slow_window_s",
        "labels",
    )

    def __init__(
        self,
        name: str,
        series: str,
        threshold: float,
        percentile: float = 99.0,
        objective: Optional[float] = None,
        fast_window_s: float = DEFAULT_FAST_WINDOW_S,
        slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
        labels: Optional[Dict[str, str]] = None,
    ) -> None:
        if not 0.0 < percentile < 100.0:
            raise ValueError(f"percentile must be in (0, 100), got {percentile!r}")
        if threshold <= 0.0:
            raise ValueError(f"threshold must be positive, got {threshold!r}")
        if objective is None:
            objective = percentile / 100.0
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective!r}")
        if fast_window_s <= 0.0 or slow_window_s < fast_window_s:
            raise ValueError(
                "windows must satisfy 0 < fast_window_s <= slow_window_s, got"
                f" {fast_window_s!r} / {slow_window_s!r}"
            )
        self.name = name
        self.series = series
        self.percentile = float(percentile)
        self.threshold = float(threshold)
        self.objective = float(objective)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.labels = dict(labels or {})

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "series": self.series,
            "percentile": self.percentile,
            "threshold": self.threshold,
            "objective": self.objective,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
        }
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


def burn_rate(bad: float, total: float, objective: float) -> float:
    """The SRE burn rate: observed bad fraction over the budgeted bad
    fraction. 1.0 burns the error budget exactly at the objective's rate;
    >1 exhausts it early. 0.0 when the window holds no observations."""
    if total <= 0.0:
        return 0.0
    return (bad / total) / (1.0 - objective)


class SLORegistry:
    """Declared SLOs plus their evaluation state (one process-global
    instance, :data:`SLO_REGISTRY`).

    Evaluation is pull-based and side-effect-light: :meth:`evaluate` reads
    the histogram registry's window views and updates only the edge-trigger
    bookkeeping (``breaches_total`` counts *transitions into* breach, so it
    is invariant to evaluation frequency). Nothing here runs on the metric
    hot path."""

    def __init__(self, histograms: Optional[HistogramRegistry] = None) -> None:
        self._lock = threading.Lock()
        self._histograms = histograms if histograms is not None else HISTOGRAMS
        self._slos: Dict[str, SLO] = {}
        self._breached: Dict[str, bool] = {}
        self._breaches_total: Dict[str, int] = {}
        self._last_status: Dict[str, Dict[str, Any]] = {}

    # -- declaration ---------------------------------------------------------

    def declare(self, slo: Optional[SLO] = None, /, **kwargs: Any) -> SLO:
        """Register an :class:`SLO` (or build one from kwargs). Redeclaring
        a name replaces the declaration and resets its breach state."""
        if slo is None:
            slo = SLO(**kwargs)
        elif kwargs:
            raise TypeError("pass an SLO instance or kwargs, not both")
        with self._lock:
            self._slos[slo.name] = slo
            self._breached[slo.name] = False
            self._breaches_total.setdefault(slo.name, 0)
            self._last_status.pop(slo.name, None)
        return slo

    def slos(self) -> Dict[str, SLO]:
        with self._lock:
            return dict(self._slos)

    def clear(self) -> None:
        """Drop every declaration and all evaluation state."""
        with self._lock:
            self._slos.clear()
            self._breached.clear()
            self._breaches_total.clear()
            self._last_status.clear()

    # -- evaluation ----------------------------------------------------------

    def _window_stats(self, slo: SLO, seconds: float) -> Tuple[float, float, float]:
        """``(bad, total, percentile_estimate)`` over the matching series'
        summed window buckets. Series match on exact name plus label-subset
        containment; multiple matches (e.g. per-policy labels) sum
        elementwise — layouts are fixed per unit."""
        counts: Optional[np.ndarray] = None
        min_exp = 0
        for _, hist, labels, name in self._histograms.series_items():
            if name != slo.series:
                continue
            if any(labels.get(k) != v for k, v in slo.labels.items()):
                continue
            win = hist.window(seconds)
            if counts is None:
                counts = win.bucket_counts()
                min_exp = win.min_exp
            else:
                counts = counts + win.bucket_counts()
        if counts is None:
            return 0.0, 0.0, 0.0
        from .histogram import _percentile_from

        total = float(counts.sum())
        bad = _bad_count(counts, min_exp, slo.threshold)
        return bad, total, _percentile_from(counts, min_exp, slo.percentile)

    def _evaluate_one(self, slo: SLO) -> Dict[str, Any]:
        fast_bad, fast_total, fast_p = self._window_stats(slo, slo.fast_window_s)
        slow_bad, slow_total, _ = self._window_stats(slo, slo.slow_window_s)
        burn_fast = burn_rate(fast_bad, fast_total, slo.objective)
        burn_slow = burn_rate(slow_bad, slow_total, slo.objective)
        # multi-window breach: both windows burning faster than budget, and
        # the fast window non-empty (an idle series is not a breach)
        breached = burn_fast > 1.0 and burn_slow > 1.0 and fast_total > 0.0
        status = slo.to_dict()
        status["fast"] = {
            "window_s": slo.fast_window_s,
            "total": fast_total,
            "bad": round(fast_bad, 6),
            "burn_rate": round(burn_fast, 6),
        }
        status["slow"] = {
            "window_s": slo.slow_window_s,
            "total": slow_total,
            "bad": round(slow_bad, 6),
            "burn_rate": round(burn_slow, 6),
        }
        status["window_p"] = round(fast_p, 9)
        status["budget_remaining"] = round(max(0.0, 1.0 - burn_slow), 6)
        status["breached"] = breached
        return status

    def evaluate(self) -> Dict[str, Dict[str, Any]]:
        """Evaluate every declared SLO now; returns ``name -> status`` and
        updates the edge-triggered breach accounting. Transitions (breach
        entered / cleared) are flagged under the ``"transition"`` key so the
        watchdog can emit events without re-deriving them."""
        with self._lock:
            slos = list(self._slos.values())
        statuses: Dict[str, Dict[str, Any]] = {}
        for slo in slos:
            status = self._evaluate_one(slo)
            with self._lock:
                was = self._breached.get(slo.name, False)
                now_breached = bool(status["breached"])
                if now_breached and not was:
                    self._breaches_total[slo.name] = self._breaches_total.get(slo.name, 0) + 1
                    status["transition"] = "breach"
                elif was and not now_breached:
                    status["transition"] = "recover"
                self._breached[slo.name] = now_breached
                status["breaches_total"] = self._breaches_total.get(slo.name, 0)
                self._last_status[slo.name] = status
            statuses[slo.name] = status
        return statuses

    def breaches(self) -> Dict[str, Dict[str, Any]]:
        """Freshly-evaluated statuses of the currently-breached SLOs — the
        machine-readable hook a serving controller polls."""
        return {
            name: status
            for name, status in self.evaluate().items()
            if status["breached"]
        }

    # -- export --------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """The ``snapshot()["slo"]`` section: ``{}`` until the first
        declaration (planes report nothing until touched), else the last
        evaluated status per SLO plus plane-level totals."""
        with self._lock:
            if not self._slos:
                return {}
            statuses = {
                name: dict(self._last_status[name])
                for name in self._slos
                if name in self._last_status
            }
            breaches_total = sum(self._breaches_total.get(n, 0) for n in self._slos)
        return {
            "window_epoch_s": self._histograms.window_epoch_s,
            "breaches_total": breaches_total,
            "slos": statuses,
        }

    def reset(self) -> None:
        """Full reset: declarations and state (the ``observability.reset()``
        path)."""
        self.clear()


class SLOWatchdog:
    """Tick-driven breach detector (one process-global instance,
    :data:`WATCHDOG`) — the caller owns the cadence (a soak loop, a serving
    read loop, a scheduler heartbeat); there is no background thread and
    nothing runs unless :meth:`tick` is called.

    Each tick: rotate the histogram window rings to ``now``, re-evaluate
    every SLO, and emit an edge-triggered ``slo`` timeline event per breach /
    recovery transition. Disabled telemetry makes a tick a no-op."""

    def __init__(self, registry: Optional[SLORegistry] = None) -> None:
        self._registry = registry
        self._lock = threading.Lock()
        self._ticks = 0

    @property
    def registry(self) -> SLORegistry:
        return self._registry if self._registry is not None else SLO_REGISTRY

    @property
    def ticks(self) -> int:
        return self._ticks

    def tick(self, now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """One watchdog evaluation; returns ``name -> status`` (empty when
        telemetry is disabled or nothing is declared)."""
        if not TELEMETRY.enabled:
            return {}
        reg = self.registry
        if now is None:
            now = time.monotonic()
        reg._histograms.rotate(now)
        with self._lock:
            self._ticks += 1
        statuses = reg.evaluate()
        for name, status in statuses.items():
            transition = status.get("transition")
            if transition is not None:
                EVENTS.record(
                    "slo",
                    name,
                    state=transition,
                    series=status["series"],
                    burn_fast=status["fast"]["burn_rate"],
                    burn_slow=status["slow"]["burn_rate"],
                    budget_remaining=status["budget_remaining"],
                    window_p=status["window_p"],
                    threshold=status["threshold"],
                )
        return statuses

    def reset(self) -> None:
        with self._lock:
            self._ticks = 0


#: the process-global SLO registry and its watchdog
SLO_REGISTRY = SLORegistry()
WATCHDOG = SLOWatchdog()


def summary() -> Dict[str, Any]:
    """The SLO plane's snapshot section (``{}`` until an SLO is declared)."""
    out = SLO_REGISTRY.summary()
    if out:
        out["ticks"] = WATCHDOG.ticks
    return out
