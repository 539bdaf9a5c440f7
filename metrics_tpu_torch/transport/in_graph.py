"""InGraphTransport: the named in-graph backend, delegating to the eager pair.

Counterpart of ``metrics_tpu/transport/in_graph.py``. The JAX package's
in-graph backend lowers a traced program's sync to packed ``jax.lax``
collectives. The port has no traced collective: a compiled step (a CUDA
graph) holds no cross-process round, and the packed sync is the eager
``utilities/distributed.py::sync_state_packed``. This class keeps the name
so code written against the JAX package's transports runs unchanged: every
gather, reduction and subgroup delegates to ``eager`` (default: the auto
loopback/gather pair), and its results equal that pair's.
"""
from typing import Any, Dict, List, Optional, Sequence

from metrics_tpu_torch.transport.base import Transport

__all__ = ["InGraphTransport"]


class InGraphTransport(Transport):
    """The in-graph backend's name over the eager transports."""

    name = "in_graph"

    def __init__(self, eager: Optional[Transport] = None) -> None:
        if eager is not None and not isinstance(eager, Transport):
            raise TypeError(f"eager must be a Transport, got {eager!r}")
        self._eager_override = eager

    def gather_pytrees(self, trees: List[Any], group: Optional[Any] = None) -> List[Any]:
        return self._eager().gather_pytrees(trees, group=group)

    def gather_array(self, result: Any, group: Optional[Any] = None) -> List[Any]:
        return self._eager().gather_array(result, group=group)

    def reduce_states(self, states: Dict[str, Any], reductions: Dict[str, Any],
                      group: Optional[Any] = None) -> Optional[Dict[str, Any]]:
        return self._eager().reduce_states(states, reductions, group=group)

    def place_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return self._eager().place_state(state)

    @property
    def participants(self) -> Optional[List[int]]:
        return self._eager().participants

    def subgroup(self, members: Sequence[int]) -> Transport:
        sub = self._eager().subgroup(members)
        return InGraphTransport(eager=sub) if sub is not self._eager() else self

    def _eager(self) -> Transport:
        if self._eager_override is not None:
            return self._eager_override
        from metrics_tpu_torch.transport.base import _AUTO

        return _AUTO._eager()
