"""Phi-accrual failure detection fed by the signals the repo already emits.

Counterpart of ``metrics_tpu/resilience/detector.py`` (``FailureDetector``
``:72``, ``note_round_outcome`` ``:253``, ``note_straggler_report``
``:259``), the same host-side code; a process never convicts its own
``torch.distributed`` rank.

The straggler report and the gather-round outcomes are *evidence*;
this module turns them into *verdicts* and drives the membership epoch:

* **Heartbeats**: every successful transport round a peer participates in
  is a heartbeat (:meth:`FailureDetector.heartbeat` /
  :meth:`observe_round`). The detector keeps a sliding window of
  inter-arrival intervals per peer and computes the phi-accrual suspicion
  level (Hayashibara et al.): ``phi = -log10(P(a heartbeat arrives later
  than the observed silence))`` under a normal model of the peer's own
  interval history. Phi grows continuously with silence, scaled by how
  regular the peer used to be — a noisy peer needs a longer silence to
  reach the same suspicion as a metronomic one.
* **Round outcomes**: a failed round (:meth:`observe_round` with
  ``ok=False``) charges its suspected peers a consecutive-failure strike;
  ``fail_after`` strikes is an independent promotion path for deployments
  whose rounds are too sparse for interval statistics.
* **Straggler reports**: :func:`note_straggler_report` (called by
  :func:`~metrics_tpu_torch.observability.tracing.straggler_report` on publish)
  charges each flagged process a strike — the clock-aligned
  wait-for-slowest evidence feeds the same ledger.
* **Promotion**: :meth:`promote` compares verdicts against the
  :class:`~metrics_tpu_torch.resilience.membership.Membership` and applies the
  difference — new suspects are marked failed (epoch bump each), and a
  suspect whose heartbeats resumed is *eligible* for rejoin, applied only
  when ``auto_rejoin=True`` (default False: rejoin is an explicit
  operator/harness decision, see membership.py).

The detector is process-local, lock-protected, allocation-light, and never
touches traced code.
"""
import math
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from metrics_tpu_torch.resilience.membership import MEMBERSHIP, Membership, MembershipView
from metrics_tpu_torch.resilience.telemetry import RESILIENCE_STATS

__all__ = [
    "DETECTOR",
    "FailureDetector",
    "note_round_outcome",
    "note_straggler_report",
]

#: phi above this is "the peer is gone" (phi 8 ~= a silence the peer's own
#: history says happens with probability 1e-8)
DEFAULT_PHI_THRESHOLD = 8.0
#: consecutive failed-round strikes that promote independent of phi
DEFAULT_FAIL_AFTER = 3
#: interval-window length per peer
DEFAULT_WINDOW = 64
#: floor on the modeled interval std-dev — absorbs scheduler jitter so a
#: perfectly regular peer cannot trip on microseconds of noise
DEFAULT_MIN_STD_S = 0.02


class _PeerLedger:
    __slots__ = ("last_at", "intervals", "strikes", "rounds_ok", "rounds_failed")

    def __init__(self, window: int) -> None:
        self.last_at: Optional[float] = None
        self.intervals: deque = deque(maxlen=window)
        self.strikes = 0
        self.rounds_ok = 0
        self.rounds_failed = 0


class FailureDetector:
    """Phi-accrual + strike-count failure detector over the process fleet.

    Args:
        membership: the :class:`Membership` promotions apply to (default:
            the process-global one).
        phi_threshold: suspicion level that promotes (see module docs).
        fail_after: consecutive failed-round strikes that promote.
        window: retained inter-arrival intervals per peer.
        min_std_s: floor on the modeled interval spread.
        auto_rejoin: when True, :meth:`promote` also rejoins recovered
            peers; default False — rejoin stays an explicit decision.
        clock: time source (tests inject a fake; defaults to
            ``time.monotonic``).
    """

    def __init__(
        self,
        *,
        membership: Optional[Membership] = None,
        phi_threshold: float = DEFAULT_PHI_THRESHOLD,
        fail_after: int = DEFAULT_FAIL_AFTER,
        window: int = DEFAULT_WINDOW,
        min_std_s: float = DEFAULT_MIN_STD_S,
        auto_rejoin: bool = False,
        clock=time.monotonic,
    ) -> None:
        if float(phi_threshold) <= 0:
            raise ValueError(f"phi_threshold must be > 0, got {phi_threshold}")
        if int(fail_after) < 1:
            raise ValueError(f"fail_after must be >= 1, got {fail_after}")
        self.membership = membership if membership is not None else MEMBERSHIP
        self.phi_threshold = float(phi_threshold)
        self.fail_after = int(fail_after)
        self.window = int(window)
        self.min_std_s = float(min_std_s)
        self.auto_rejoin = bool(auto_rejoin)
        self._clock = clock
        self._lock = threading.Lock()
        self._peers: Dict[int, _PeerLedger] = {}

    def _ledger(self, peer: int) -> _PeerLedger:
        ledger = self._peers.get(peer)
        if ledger is None:
            ledger = self._peers[peer] = _PeerLedger(self.window)
        return ledger

    # -- evidence ------------------------------------------------------------

    def heartbeat(self, peer: int, at: Optional[float] = None) -> None:
        """One liveness signal from ``peer`` (a round it completed, a
        straggler-report clean bill). Clears its strike count."""
        now = self._clock() if at is None else float(at)
        with self._lock:
            ledger = self._ledger(int(peer))
            if ledger.last_at is not None and now > ledger.last_at:
                ledger.intervals.append(now - ledger.last_at)
            ledger.last_at = now
            ledger.strikes = 0

    def observe_round(
        self,
        peers: Iterable[int],
        ok: bool,
        *,
        at: Optional[float] = None,
        reason: str = "round",
    ) -> None:
        """One transport-round outcome: success heartbeats every
        participant; failure charges each suspected participant a strike."""
        now = self._clock() if at is None else float(at)
        if ok:
            for p in peers:
                self.heartbeat(p, at=now)
            return
        with self._lock:
            for p in peers:
                ledger = self._ledger(int(p))
                ledger.strikes += 1
                ledger.rounds_failed += 1

    # -- verdicts ------------------------------------------------------------

    def phi(self, peer: int, now: Optional[float] = None) -> float:
        """The peer's current phi-accrual suspicion (0.0 while it has no
        interval history — a silent never-seen peer is judged by strikes,
        not by statistics it never generated)."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            ledger = self._peers.get(int(peer))
            if ledger is None or ledger.last_at is None or not ledger.intervals:
                return 0.0
            elapsed = now - ledger.last_at
            if elapsed <= 0:
                return 0.0
            n = len(ledger.intervals)
            mean = sum(ledger.intervals) / n
            var = sum((x - mean) ** 2 for x in ledger.intervals) / n
            std = max(math.sqrt(var), self.min_std_s)
        # P(interval > elapsed) under N(mean, std); phi = -log10 of it
        p_later = 0.5 * math.erfc((elapsed - mean) / (std * math.sqrt(2.0)))
        if p_later <= 0.0:
            return float("inf")
        return -math.log10(p_later)

    def suspects(self, now: Optional[float] = None) -> List[int]:
        """Peers the evidence currently convicts: phi past the threshold OR
        strike count past ``fail_after``."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            peers = list(self._peers)
            strikes = {p: self._peers[p].strikes for p in peers}
        out = []
        for p in peers:
            if strikes[p] >= self.fail_after or self.phi(p, now=now) >= self.phi_threshold:
                out.append(p)
        return sorted(out)

    # -- promotion -----------------------------------------------------------

    def promote(self, now: Optional[float] = None) -> MembershipView:
        """Apply the current verdicts to the membership: each NEW suspect is
        marked failed (one epoch bump + transition record each, counted
        ``detector_suspects``); with ``auto_rejoin``, each dead peer whose
        evidence cleared is rejoined. Returns the resulting view."""
        suspects = set(self.suspects(now=now))
        # a process never convicts ITSELF: its own silence in the ledger
        # means it was busy, not dead (it is running this very code)
        from metrics_tpu_torch.observability.tracing import _process_index

        suspects.discard(_process_index())
        view = self.membership.current()
        for peer in sorted(suspects - set(view.dead)):
            RESILIENCE_STATS.inc("detector_suspects")
            view = self.membership.mark_failed(peer, reason="phi-accrual")
        if self.auto_rejoin:
            for peer in sorted(set(view.dead) - suspects):
                # only rejoin on positive evidence, not mere strike decay
                with self._lock:
                    ledger = self._peers.get(peer)
                    seen = ledger is not None and ledger.strikes == 0 and ledger.last_at is not None
                if seen and self.phi(peer, now=now) < self.phi_threshold:
                    view = self.membership.mark_recovered(peer, reason="detector")
        return view

    # -- reading -------------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        now = self._clock()
        with self._lock:
            snap = {
                p: (ledger.strikes, len(ledger.intervals))
                for p, ledger in sorted(self._peers.items())
            }
        return {
            "peers": {
                p: {
                    "phi": round(self.phi(p, now=now), 3),
                    "strikes": strikes,
                    "intervals": nints,
                }
                for p, (strikes, nints) in snap.items()
            },
            "suspects": self.suspects(now=now),
            "phi_threshold": self.phi_threshold,
            "fail_after": self.fail_after,
            "membership": self.membership.summary(),
        }

    def reset(self) -> None:
        with self._lock:
            self._peers.clear()


#: the process-global detector, bound to the global membership
DETECTOR = FailureDetector()


def note_round_outcome(peers: Iterable[int], ok: bool, *, reason: str = "round") -> None:
    """Module-level evidence hook the async engine calls per attempt
    (guarded there — diagnostics must never break a sync)."""
    DETECTOR.observe_round(peers, ok, reason=reason)


def note_straggler_report(flagged: Iterable[int]) -> None:
    """Evidence hook :func:`~metrics_tpu_torch.observability.tracing
    .straggler_report` calls on publish: each flagged process takes a
    strike (clean processes are NOT heartbeaten here — the report proves
    slowness, not liveness)."""
    DETECTOR.observe_round(flagged, ok=False, reason="straggler")
