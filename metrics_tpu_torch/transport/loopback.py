"""LoopbackTransport: the identity of a world of one process.

Counterpart of ``metrics_tpu/transport/loopback.py:34-170``, eager half: the
gather hands every leaf back as a one-member list holding the same tensor
(no rounds, no copy), and :meth:`LoopbackTransport.reduce_states` hands the
elementwise-reduced tensor leaves back as they are, so the caller gathers
only the rest. The default whenever ``distributed_available()`` is false.
"""
from typing import Any, Dict, List, Optional, Sequence

from metrics_tpu_torch.transport.base import Transport


class LoopbackTransport(Transport):
    """Identity transport for a world of one process."""

    name = "loopback"

    def gather_pytrees(self, trees: List[Any], group: Optional[Any] = None) -> List[Any]:
        from metrics_tpu_torch.utilities import distributed as _dist

        if group is not None:  # nothing to desync: validate now
            _dist._resolve_group(group, 1)
        return _dist._tree_refill(list(trees), iter([[leaf] for leaf in _dist._tree_leaves(trees, [])]))

    def reduce_states(
        self, states: Dict[str, Any], reductions: Dict[str, Any], group: Optional[Any] = None
    ) -> Optional[Dict[str, Any]]:
        handled = {
            name: value
            for name, value in states.items()
            if not isinstance(value, (list, tuple)) and reductions.get(name) in ("sum", "mean", "max", "min")
        }
        return handled or None

    @property
    def participants(self) -> Optional[List[int]]:
        return [0]

    def subgroup(self, members: Sequence[int]) -> Transport:
        return self

    def distributed(self) -> bool:
        return False
