"""Epoch-based process membership: the versioned "who is alive" view.

Counterpart of ``metrics_tpu/resilience/membership.py`` (``Membership``
``:65``), the same host-side code over the ``torch.distributed`` world.

The straggler report's :func:`~metrics_tpu_torch.observability.tracing.degraded_processes` is a
per-attempt HINT — each degraded-link policy consulted it independently,
right before its own transport attempt, and nothing tied one plane's view
of the fleet to another's. This module promotes it to a **versioned
membership epoch**:

* :class:`Membership` holds ``(epoch, alive set)``; every transition —
  a peer marked failed by the detector, a recovered peer explicitly
  rejoining — **bumps the epoch** and is recorded (the
  ``resilience.epoch_transitions`` counter and a ``resilience`` timeline
  event per transition, with peer/reason/epoch).
* Consumers read :meth:`current` and compare epochs instead of re-deriving
  peer health: the async engine's quorum forms its healthy subgroup from
  the membership's alive set (unioned with the per-attempt straggler hint
  — the hint can only narrow, never resurrect), and the serving
  scheduler's read path treats a cached value from an older epoch as
  expired (a fleet transition invalidates values computed under the old
  peer set).
* A recovered peer REJOINS only explicitly (:meth:`mark_recovered` /
  :meth:`rejoin`) — recovery is an operator/detector decision with its own
  epoch bump, never an implicit timeout, so two processes can never
  disagree about whether an epoch's peer set includes a flapping node.

The membership object is process-local state about the fleet (like the
span tracker): each process maintains its own view, converging through the
same signals. The epoch is monotonic; ``snapshot()["resilience"]["epoch"]``
merges as ``max`` across the fleet.
"""
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from metrics_tpu_torch.resilience.telemetry import note_transition

__all__ = [
    "MEMBERSHIP",
    "Membership",
    "MembershipView",
    "alive_processes",
    "current_epoch",
    "current_view",
    "dead_processes",
]

#: bound on retained transition records (~100 bytes each)
_TRANSITION_CAP = 256


class MembershipView(NamedTuple):
    """One immutable epoch: the version number and the peer partition."""

    epoch: int
    alive: Tuple[int, ...]
    dead: Tuple[int, ...]


def _world() -> int:
    from metrics_tpu_torch.utilities.distributed import world_size

    return world_size()


class Membership:
    """Versioned fleet membership (one process-global instance,
    :data:`MEMBERSHIP`; private instances supported for tests).

    ``world=None`` sizes lazily from
    :func:`~metrics_tpu_torch.utilities.distributed.world_size` at first use, so
    constructing the module costs nothing on a single-process run."""

    def __init__(self, world: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._world = int(world) if world is not None else None
        self._epoch = 0
        self._dead: set = set()
        self._transitions: List[Dict[str, Any]] = []

    # -- internals -----------------------------------------------------------

    def _ensure_world(self) -> int:
        if self._world is None:
            self._world = _world()
        return self._world

    def _view_locked(self) -> MembershipView:
        world = self._ensure_world()
        dead = tuple(sorted(p for p in self._dead if p < world))
        alive = tuple(p for p in range(world) if p not in self._dead)
        return MembershipView(self._epoch, alive, dead)

    def _record(self, kind: str, peer: int, reason: str) -> None:
        self._transitions.append(
            {
                "epoch": self._epoch,
                "kind": kind,
                "peer": int(peer),
                "reason": reason,
                "at_s": time.monotonic(),
            }
        )
        if len(self._transitions) > _TRANSITION_CAP:
            del self._transitions[: len(self._transitions) - _TRANSITION_CAP]

    # -- transitions ---------------------------------------------------------

    def mark_failed(self, peer: int, *, reason: str = "detector") -> MembershipView:
        """Remove ``peer`` from the alive set with an epoch bump (idempotent:
        re-marking a dead peer neither bumps nor records)."""
        peer = int(peer)
        with self._lock:
            world = self._ensure_world()
            if peer < 0 or peer >= world:
                raise ValueError(f"peer {peer} outside world of {world}")
            if peer in self._dead:
                return self._view_locked()
            if len(self._dead) + 1 >= world:
                raise ValueError(
                    f"refusing to mark peer {peer} failed: the alive set would be"
                    " empty — at least one process must remain a member"
                )
            self._dead.add(peer)
            self._epoch += 1
            self._record("failure", peer, reason)
            view = self._view_locked()
        note_transition(view.epoch, "failure", peer, reason)
        return view

    def mark_recovered(self, peer: int, *, reason: str = "rejoin") -> MembershipView:
        """Re-admit ``peer`` with an EXPLICIT epoch bump (idempotent). This
        is the only way back in — recovery is a decision, not a timeout."""
        peer = int(peer)
        with self._lock:
            if peer not in self._dead:
                return self._view_locked()
            self._dead.discard(peer)
            self._epoch += 1
            self._record("rejoin", peer, reason)
            view = self._view_locked()
        note_transition(view.epoch, "rejoin", peer, reason)
        return view

    #: the operator-facing alias — "the peer is back, bump the epoch"
    rejoin = mark_recovered

    # -- reading -------------------------------------------------------------

    def current(self) -> MembershipView:
        with self._lock:
            return self._view_locked()

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def alive(self) -> List[int]:
        return list(self.current().alive)

    def dead(self) -> List[int]:
        return list(self.current().dead)

    def is_alive(self, peer: int) -> bool:
        with self._lock:
            return int(peer) not in self._dead

    def transitions(self) -> List[Dict[str, Any]]:
        """The bounded transition history (newest last) — every epoch bump
        with its peer, direction and reason."""
        with self._lock:
            return [dict(t) for t in self._transitions]

    def summary(self) -> Dict[str, Any]:
        view = self.current()
        return {
            "epoch": view.epoch,
            "alive": list(view.alive),
            "dead": list(view.dead),
            "transitions": len(self.transitions()),
        }

    def reset(self, world: Optional[int] = None) -> None:
        """Back to epoch 0, everyone alive (tests; like any cross-process
        state, reset on every process together or on none)."""
        with self._lock:
            self._epoch = 0
            self._dead.clear()
            self._transitions.clear()
            if world is not None:
                self._world = int(world)

    def __repr__(self) -> str:
        view = self.current()
        return f"Membership(epoch={view.epoch}, alive={list(view.alive)}, dead={list(view.dead)})"


#: the process-global membership view
MEMBERSHIP = Membership()


def current_view() -> MembershipView:
    """The global membership's current ``(epoch, alive, dead)``."""
    return MEMBERSHIP.current()


def current_epoch() -> int:
    """The global membership epoch (0 until the first transition)."""
    return MEMBERSHIP.epoch


def alive_processes() -> List[int]:
    return MEMBERSHIP.alive()


def dead_processes() -> List[int]:
    """Peers the current epoch excludes — what the async engine unions with
    the per-attempt straggler hint."""
    return MEMBERSHIP.dead()
