"""GatherTransport: the descriptor + payload rounds over ``torch.distributed``.

Counterpart of ``metrics_tpu/transport/gather.py:240-301``. The rounds are
``utilities/distributed.py::_gather_all_leaves``; a transport bound to a
subset of ranks (:meth:`GatherTransport.subgroup`) narrows the decoded
members and never widens them, while its rounds still span the group: the
JAX package's behaviour when no subgroup channel is registered. The
KV-store subgroup channel (``gather.py:88-237``) and the fault seams are
not ported yet (ROADMAP, queue A item 14).
"""
from typing import List, Optional, Sequence

from metrics_tpu_torch.transport.base import Transport


class GatherTransport(Transport):
    """The eager byte-transport backend.

    ``participants=None`` decodes every member of the group; a bound
    instance decodes only those of its participants.
    """

    name = "gather"

    def __init__(self, *, participants: Optional[Sequence[int]] = None) -> None:
        self._participants = sorted({int(p) for p in participants}) if participants is not None else None
        if self._participants is not None and not self._participants:
            raise ValueError("participants must name at least one process index")

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
        return GatherTransport(participants=narrowed)
