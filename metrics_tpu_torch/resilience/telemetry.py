"""The ``resilience.*`` telemetry family: evidence for the robustness plane.

Counterpart of ``metrics_tpu/resilience/telemetry.py``. One process-global
:class:`ResilienceStats` ledger records every injected fault (by seam and
mode), every failure-detector verdict, every membership epoch transition
(failures and rejoins apart) and every policy decision (retries spent,
deadline exhaustions, circuit-breaker opens and short-circuits). The ledger
surfaces as ``observability.snapshot()["resilience"]`` (``{}`` until first
touched), the ``metrics_tpu_resilience_*`` Prometheus series and one
``resilience`` timeline event per fault and per transition.

Counting sits behind the lock-free ``TELEMETRY.enabled`` gate, but for
membership transitions, which are always counted.
"""
import threading
from typing import Any, Dict

from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.registry import TELEMETRY

__all__ = [
    "RESILIENCE_STATS",
    "ResilienceStats",
    "note_fault",
    "note_transition",
    "summary",
]


class ResilienceStats:
    """Thread-safe counters for the resilience plane (one process-global
    instance, :data:`RESILIENCE_STATS`; private instances supported for
    tests). ``touched`` stays False until the first fault fires, detector
    verdict lands, or epoch moves, so an idle process's snapshot omits the
    section entirely."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._touched = False
        self._counters: Dict[str, int] = {
            "faults_injected": 0,
            "detector_suspects": 0,
            "peer_failures": 0,
            "peer_rejoins": 0,
            "epoch_transitions": 0,
            "policy_retries": 0,
            "deadline_exhausted": 0,
            "breaker_opens": 0,
            "breaker_short_circuits": 0,
        }
        self._faults_by_seam: Dict[str, int] = {}
        self._epoch = 0

    # -- recording ----------------------------------------------------------

    def inc(self, counter: str, n: int = 1) -> None:
        if not TELEMETRY.enabled:
            return
        with self._lock:
            self._touched = True
            self._counters[counter] = self._counters.get(counter, 0) + int(n)

    def fault(self, seam: str, mode: str) -> None:
        """One injected fault — the per-(seam, mode) split and the total
        move together, so the fault-schedule accounting can never drift."""
        if not TELEMETRY.enabled:
            return
        key = f"{seam}:{mode}"
        with self._lock:
            self._touched = True
            self._counters["faults_injected"] += 1
            self._faults_by_seam[key] = self._faults_by_seam.get(key, 0) + 1

    def transition(self, epoch: int, kind: str) -> None:
        """One membership epoch transition (``kind`` = ``failure`` /
        ``rejoin``). Counted unconditionally: the epoch is part of the
        cross-process contract, not a diagnostic."""
        with self._lock:
            self._touched = True
            self._counters["epoch_transitions"] += 1
            self._counters["peer_failures" if kind == "failure" else "peer_rejoins"] += 1
            if epoch > self._epoch:
                self._epoch = int(epoch)

    # -- reading ------------------------------------------------------------

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def summary(self) -> Dict[str, Any]:
        """The ``snapshot()["resilience"]`` section (``{}`` when
        untouched)."""
        with self._lock:
            if not self._touched:
                return {}
            return {
                **dict(self._counters),
                "faults_by_seam": dict(self._faults_by_seam),
                "epoch": self._epoch,
            }

    def reset(self) -> None:
        """Zero every counter and the epoch high-water (the live membership
        object keeps its own epoch — reset it separately, and like any
        cross-process state, on every process together or on none)."""
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0
            self._faults_by_seam.clear()
            self._epoch = 0
            self._touched = False


#: the process-global resilience ledger
RESILIENCE_STATS = ResilienceStats()


def summary() -> Dict[str, Any]:
    """Module-level accessor ``observability.snapshot()`` reads."""
    return RESILIENCE_STATS.summary()


def note_fault(seam: str, mode: str, **payload: Any) -> None:
    """One injected fault: counter + a ``resilience`` timeline event, so the
    chaos schedule is reconstructible from the exported trace."""
    RESILIENCE_STATS.fault(seam, mode)
    if EVENTS.enabled:
        EVENTS.record(
            "resilience", seam, path="fault", mode=mode,
            **{k: v for k, v in payload.items() if v is not None},
        )


def note_transition(epoch: int, kind: str, peer: int, reason: str) -> None:
    """One membership transition: counter (unconditional) + a ``resilience``
    timeline event (telemetry-gated like every event)."""
    RESILIENCE_STATS.transition(epoch, kind)
    if EVENTS.enabled:
        EVENTS.record(
            "resilience", "membership", path=kind, epoch=int(epoch),
            peer=int(peer), reason=reason,
        )
