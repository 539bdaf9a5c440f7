"""GatherTransport: the descriptor + payload rounds, with true subgroups.

Counterpart of ``metrics_tpu/transport/gather.py``. The rounds are
``utilities/distributed.py::_gather_all_leaves``. A transport bound to a
subset of ranks (:meth:`GatherTransport.subgroup`) runs both rounds over
those ranks alone through the registered **subgroup channel**, a primitive
that exchanges equal-length byte buffers among an explicit peer set without
involving anyone else, so a quorum round never contacts a dead peer:

* :func:`set_subgroup_allgather` installs a channel (a test harness installs
  an in-process one);
* :class:`StoreSubgroupChannel` is the production channel, the counterpart
  of ``kvstore_subgroup_allgather`` (``gather.py:146-237``): each
  participant ``set``s its buffer under a deterministic ``(peer set, round,
  rank)`` key of a ``torch.distributed`` store and ``wait``s/``get``s only its
  co-participants' keys, under one deadline for the whole round. It never
  calls ``new_group``, which needs every rank and would hang on a dead one;
* the channel over the default process group's store is the **auto
  default**: when ``torch.distributed`` is initialised at a transport's
  creation it registers itself (:func:`maybe_register_kvstore_channel`),
  unless a channel was registered explicitly (``None`` included) or
  ``METRICS_TPU_NO_KVSTORE_SUBGROUP=1`` is set;
* with no channel registered a subgrouped round spans the group and only
  the decode narrows, and the round telemetry records the ranks the rounds
  touched (``participants``).

Both the channel's exchange (seam ``subgroup.exchange``) and the rounds
(``transport.descriptor``/``transport.payload``) consult the resilience
plane's fault plan.
"""
import os
import threading
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.resilience.faults import maybe_fault
from metrics_tpu_torch.transport.base import Transport
from metrics_tpu_torch.utilities.data import to_host

__all__ = [
    "GatherTransport",
    "StoreSubgroupChannel",
    "consume_subgroup_round",
    "kvstore_subgroup_allgather",
    "maybe_register_kvstore_channel",
    "set_subgroup_allgather",
    "subgroup_allgather",
]

#: the registered channel: ``fn(buf: Tensor, participants) -> (len(participants), ...)``
#: stacked tensor, run by every participant with identical arguments
_SUBGROUP_ALLGATHER: Optional[Callable[[torch.Tensor, List[int]], torch.Tensor]] = None
#: True once a caller registered (or cleared) the channel explicitly
_CHANNEL_EXPLICIT = False
_CHANNEL_LOCK = threading.Lock()

#: env opt-out of the store channel's auto default (anything but 0/empty)
NO_KVSTORE_ENV = "METRICS_TPU_NO_KVSTORE_SUBGROUP"


def set_subgroup_allgather(fn: Optional[Callable[[torch.Tensor, List[int]], torch.Tensor]]) -> Optional[Callable]:
    """Register (or clear, with ``None``) the subgroup channel; returns the
    previous one. An explicit registration, ``None`` included, disables the
    auto default for the rest of the process."""
    global _SUBGROUP_ALLGATHER, _CHANNEL_EXPLICIT
    with _CHANNEL_LOCK:
        previous = _SUBGROUP_ALLGATHER
        _SUBGROUP_ALLGATHER = fn
        _CHANNEL_EXPLICIT = True
    return previous


def subgroup_allgather() -> Optional[Callable]:
    """The registered subgroup channel, or ``None``."""
    return _SUBGROUP_ALLGATHER


def maybe_register_kvstore_channel() -> bool:
    """Register a :class:`StoreSubgroupChannel` over the default process
    group's store when ``torch.distributed`` is initialised and nothing was
    registered explicitly (``gather.py:88``; the name is the JAX package's,
    whose channel is its coordination service's key-value store). Returns
    True when a store channel is the registered channel after the call."""
    global _SUBGROUP_ALLGATHER
    if _CHANNEL_EXPLICIT or _SUBGROUP_ALLGATHER is not None:
        return isinstance(_SUBGROUP_ALLGATHER, StoreSubgroupChannel)
    if os.environ.get(NO_KVSTORE_ENV, "").strip() not in ("", "0"):
        return False
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return False
    with _CHANNEL_LOCK:
        if _SUBGROUP_ALLGATHER is None and not _CHANNEL_EXPLICIT:
            _SUBGROUP_ALLGATHER = _DEFAULT_CHANNEL
    return isinstance(_SUBGROUP_ALLGATHER, StoreSubgroupChannel)


def consume_subgroup_round(participants: Sequence[int]) -> bool:
    """Advance the registered channel's round counter without an exchange
    (``gather.py:120``): the consistency hook of a process that skips a round
    its peers still run (an injected payload fault between the two rounds).
    Without it the channel's rounds over that peer set would rendezvous under
    mismatched keys from then on. Returns False when no counted channel is
    registered."""
    channel = _SUBGROUP_ALLGATHER
    consume = getattr(channel, "consume_round", None)
    if consume is None:
        return False
    consume(list(participants))
    return True


class StoreSubgroupChannel:
    """Subgroup byte exchange over a ``torch.distributed`` store.

    ``store`` defaults to the default process group's store, read at the
    first exchange; ``rank_fn`` (default: this process's rank) names the
    caller, so a test can run several ranks as threads of one process over
    one store. Each ``(peer set, rank)`` keeps its own round counter, so the
    N-th round over one peer set names the same keys on every participant.

    The contract is shape- and dtype-preserving: the raw bytes of ``buf``
    ride the store and the result is the ``(len(participants),) + buf.shape``
    stack in ascending rank order, on the CPU; every participant presents an
    identically-shaped buffer (the gather protocol pads its payload round to
    the round's largest byte count), and a peer that does not raises.
    ``timeout_s`` (or a call's own) bounds the whole round: a dead peer
    surfaces as a ``RuntimeError`` once it has passed. Each rank deletes its key of round
    ``N - 1`` after the reads of round ``N``: entering round ``N`` proves every
    co-participant finished reading round ``N - 1``.
    """

    def __init__(self, store: Any = None, *, timeout_s: float = 60.0, prefix: str = "mtpu_subgroup",
                 rank_fn: Optional[Callable[[], int]] = None) -> None:
        self._store = store
        self.timeout_s = float(timeout_s)
        self.prefix = str(prefix)
        self._rank_fn = rank_fn
        self._lock = threading.Lock()
        self._rounds: Dict[Tuple[Tuple[int, ...], int], int] = {}

    def _rank(self) -> int:
        if self._rank_fn is not None:
            return int(self._rank_fn())
        from metrics_tpu_torch.observability.tracing import _process_index

        return _process_index()

    def _get_store(self) -> Any:
        if self._store is None:
            import torch.distributed as dist

            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError("StoreSubgroupChannel needs a store or an initialised torch.distributed")
            self._store = dist.distributed_c10d._get_default_store()
        return self._store

    def _next_round(self, key_set: Tuple[int, ...], rank: int) -> int:
        with self._lock:
            seq = self._rounds.get((key_set, rank), 0)
            self._rounds[(key_set, rank)] = seq + 1
        return seq

    def consume_round(self, participants: Sequence[int]) -> None:
        """Advance this rank's counter for ``participants`` (see
        :func:`consume_subgroup_round`)."""
        self._next_round(tuple(sorted(int(p) for p in participants)), self._rank())

    def __call__(self, buf: torch.Tensor, participants: Sequence[int], *,
                 timeout_s: Optional[float] = None) -> torch.Tensor:
        from metrics_tpu_torch.resilience.policies import DeadlineBudget

        rank = self._rank()
        key_set = tuple(sorted(int(p) for p in participants))
        seq = self._next_round(key_set, rank)
        # the seam fires after the counter advanced, so an injected error
        # never desyncs this rank's rounds from its peers'
        maybe_fault("subgroup.exchange", process=rank, peers=len(key_set))
        store = self._get_store()
        peers = "-".join(map(str, key_set))
        prefix = f"{self.prefix}/{peers}/{seq}"
        payload = buf.detach().contiguous()
        raw = to_host(payload.reshape(-1).view(torch.uint8), numpy=True).tobytes()
        store.set(f"{prefix}/{rank}", raw)
        budget = DeadlineBudget(self.timeout_s if timeout_s is None else timeout_s)
        rows = []
        for peer in key_set:
            key = f"{prefix}/{peer}"
            store.wait([key], timedelta(milliseconds=budget.remaining_ms(floor_ms=1.0)))
            got = store.get(key)
            if len(got) != len(raw):
                raise RuntimeError(
                    f"subgroup channel: peer {peer} published {len(got)} bytes where this rank holds"
                    f" {len(raw)}; every participant must present an identically-shaped buffer"
                )
            rows.append(torch.frombuffer(bytearray(got), dtype=torch.uint8).view(payload.dtype).reshape(payload.shape))
        if seq > 0:
            try:
                store.delete_key(f"{self.prefix}/{peers}/{seq - 1}/{rank}")
            except Exception:  # pragma: no cover - cleanup is best effort
                pass
        return torch.stack(rows)


#: the channel the auto default registers: one per process, over the
#: default process group's store, read at its first exchange
_DEFAULT_CHANNEL = StoreSubgroupChannel()


def kvstore_subgroup_allgather(buf: torch.Tensor, participants: Sequence[int], *,
                               timeout_ms: int = 60_000) -> torch.Tensor:
    """One exchange over the default process group's store: the JAX
    package's ``kvstore_subgroup_allgather`` (``gather.py:146``), through
    the process-wide channel the auto default registers (its round counters,
    so :func:`consume_subgroup_round` keeps them aligned)."""
    return _DEFAULT_CHANNEL(buf, participants, timeout_s=timeout_ms / 1e3)


class GatherTransport(Transport):
    """The eager byte-transport backend (``gather.py:240``).

    ``participants=None`` spans every member of the group; a bound instance
    runs its rounds over its participants through the subgroup channel when
    one is registered, and decodes only them otherwise. ``label`` renames the
    rounds in the telemetry (the async engine's legs are ``"dcn"``).
    """

    name = "gather"

    def __init__(self, *, participants: Optional[Sequence[int]] = None, label: Optional[str] = None) -> None:
        maybe_register_kvstore_channel()
        self._participants = sorted({int(p) for p in participants}) if participants is not None else None
        if self._participants is not None and not self._participants:
            raise ValueError("participants must name at least one process index")
        if label is not None:
            self.name = str(label)

    @property
    def participants(self) -> Optional[List[int]]:
        return list(self._participants) if self._participants is not None else None

    def subgroup(self, members: Sequence[int]) -> Transport:
        requested = sorted({int(m) for m in members})
        narrowed = (
            [m for m in requested if m in self._participants] if self._participants is not None else requested
        )
        if not narrowed:  # a subgroup never widens to the parent's members
            raise ValueError(
                f"subgroup members {requested} do not intersect this transport's participants"
                f" {self._participants if self._participants is not None else '(all processes)'}"
            )
        if narrowed == self._participants:
            return self
        return GatherTransport(participants=narrowed, label=self.name if self.name != "gather" else None)
