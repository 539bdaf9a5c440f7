"""Pluggable transport of metric state across processes (L0 strategy layer).

Counterpart of ``metrics_tpu/transport/``, eager half:

* :class:`Transport` (``base.py``): the interface, with
  :func:`set_transport`, :func:`get_transport`, :func:`use_transport`,
  :func:`resolve_transport` and :func:`active_transport_name`;
* :class:`GatherTransport` (``gather.py``): the descriptor + payload rounds
  over ``torch.distributed``;
* :class:`LoopbackTransport` (``loopback.py``): the world-1 identity, the
  default when one process takes part.

``in_graph.py`` has no counterpart here: the port has no traced program to
lower collectives into, and the eager packed sync is
``utilities/distributed.py::sync_state_packed``. ``sharded.py`` (DTensor)
is ROADMAP queue A item 14.
"""
from metrics_tpu_torch.transport.base import (  # noqa: F401
    AutoTransport,
    Transport,
    active_transport_name,
    get_transport,
    resolve_transport,
    set_transport,
    use_transport,
)
from metrics_tpu_torch.transport.gather import GatherTransport  # noqa: F401
from metrics_tpu_torch.transport.loopback import LoopbackTransport  # noqa: F401
