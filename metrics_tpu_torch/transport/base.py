"""Transport strategy interface and the resolution of the active transport.

Counterpart of ``metrics_tpu/transport/base.py:35-278``, eager half only. A
:class:`Transport` carries metric state across processes at the end of an
epoch: :meth:`Transport.gather_pytrees`/:meth:`Transport.gather_array`
return each group member's contribution so that the caller applies the
declared reductions, and :meth:`Transport.reduce_states` may reduce the
elementwise leaves in place instead (``None``: gather everything).

The active transport is, in order: a metric's own (``Metric.set_transport``),
the innermost :func:`use_transport` context of this thread, the process-wide
:func:`set_transport`, and the :class:`AutoTransport` default: the
descriptor + payload gather when ``distributed_available()``, else the
world-1 loopback. The JAX package's in-graph branch has no counterpart.
"""
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence


class Transport:
    """Strategy object for the eager sync of metric state.

    Subclasses override what they change; the base class routes the gather
    to the protocol (``utilities/distributed.py::_gather_pytrees_impl``).
    :meth:`subgroup` returns a new transport and never mutates the receiver.
    """

    #: the backend's label
    name: str = "base"

    def gather_pytrees(self, trees: List[Any], group: Optional[Any] = None) -> List[Any]:
        """Every tensor leaf of ``trees`` from every member of ``group``: each
        leaf becomes the list of the members' tensors in ascending rank order."""
        from metrics_tpu_torch.utilities.distributed import _gather_pytrees_impl

        return _gather_pytrees_impl(trees, group, participants=self.participants, label=self.name)

    def gather_array(self, result: Any, group: Optional[Any] = None) -> List[Any]:
        """Per-tensor form of :meth:`gather_pytrees` (the ``gather_all_tensors`` contract)."""
        return self.gather_pytrees([result], group=group)[0]

    def reduce_states(
        self, states: Dict[str, Any], reductions: Dict[str, Any], group: Optional[Any] = None
    ) -> Optional[Dict[str, Any]]:
        """``{name: synced leaf}`` for the leaves this transport reduces in
        place, or ``None`` to gather every leaf (the default)."""
        return None

    def place_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A restored state placed for this transport's topology: the
        identity for transports that hold state replicated."""
        return state

    @property
    def participants(self) -> Optional[List[int]]:
        """The ranks this transport's decode spans (``None``: all)."""
        return None

    def subgroup(self, members: Sequence[int]) -> "Transport":
        """A transport whose rounds span only ``members``; ``self`` where the
        backend cannot form one."""
        return self

    def distributed(self) -> bool:
        """Whether this transport spans more than one process."""
        from metrics_tpu_torch.utilities.distributed import distributed_available

        return distributed_available()

    def __repr__(self) -> str:
        extra = f", participants={self.participants}" if self.participants is not None else ""
        return f"{type(self).__name__}(name={self.name!r}{extra})"


class AutoTransport(Transport):
    """The default: the descriptor + payload gather when more than one
    process takes part, else the world-1 loopback."""

    name = "auto"

    def gather_pytrees(self, trees: List[Any], group: Optional[Any] = None) -> List[Any]:
        return self._eager().gather_pytrees(trees, group=group)

    def gather_array(self, result: Any, group: Optional[Any] = None) -> List[Any]:
        return self._eager().gather_array(result, group=group)

    def subgroup(self, members: Sequence[int]) -> Transport:
        return self._eager().subgroup(members)

    def _eager(self) -> Transport:
        # the availability is read per call, so a group initialised later
        # (or a test's stand-in) is honoured
        from metrics_tpu_torch.transport.gather import GatherTransport
        from metrics_tpu_torch.transport.loopback import LoopbackTransport
        from metrics_tpu_torch.utilities import distributed

        return GatherTransport() if distributed.distributed_available() else LoopbackTransport()


#: the auto default: what get_transport() returns when nothing is set
_AUTO = AutoTransport()
#: process-global active transport (None = auto)
_GLOBAL: Optional[Transport] = None
_GLOBAL_LOCK = threading.Lock()
#: thread-local stack of use_transport contexts (innermost wins)
_CONTEXT = threading.local()


def _check(transport: Any) -> Transport:
    if not isinstance(transport, Transport):
        raise TypeError(f"expected a metrics_tpu_torch.transport.Transport instance, got {transport!r}")
    return transport


def set_transport(transport: Optional[Transport]) -> Optional[Transport]:
    """Install ``transport`` process-wide (``None``: the auto default) and
    return the previous one. Install the same transport on every process."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        previous = _GLOBAL
        _GLOBAL = _check(transport) if transport is not None else None
    return previous


def get_transport() -> Transport:
    """The active transport of this thread: innermost :func:`use_transport`
    context, else the process-wide one, else the auto default."""
    stack = getattr(_CONTEXT, "stack", None)
    if stack:
        return stack[-1]
    return _GLOBAL if _GLOBAL is not None else _AUTO


def resolve_transport(metric: Any = None) -> Transport:
    """The metric's own transport where it set one, else :func:`get_transport`."""
    override = getattr(metric, "_transport", None) if metric is not None else None
    return override if override is not None else get_transport()


def active_transport_name() -> str:
    """The active transport's label."""
    return get_transport().name


@contextmanager
def use_transport(transport: Transport):
    """Make ``transport`` the active one of this thread for the block;
    contexts nest, and every exit, raising or not, restores the previous one."""
    _check(transport)
    stack = getattr(_CONTEXT, "stack", None)
    if stack is None:
        stack = _CONTEXT.stack = []
    stack.append(transport)
    try:
        yield transport
    finally:
        for i in range(len(stack) - 1, -1, -1):  # our own entry, even if exits come out of order
            if stack[i] is transport:
                del stack[i]
                break
