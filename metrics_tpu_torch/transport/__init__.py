"""Pluggable transport of metric state across processes (L0 strategy layer).

Counterpart of ``metrics_tpu/transport/``, with its exports:

* :class:`Transport` (``base.py``): the interface, with
  :func:`set_transport`, :func:`get_transport`, :func:`use_transport`,
  :func:`resolve_transport` and :func:`active_transport_name`;
* :class:`GatherTransport` (``gather.py``): the descriptor + payload rounds
  over ``torch.distributed``, with true subgroups through the registered
  subgroup channel (:class:`StoreSubgroupChannel` over a
  ``torch.distributed`` store by default);
* :class:`LoopbackTransport` (``loopback.py``): the world-1 identity, the
  default when one process takes part;
* :class:`ShardedTransport` (``sharded.py``): state sharded on a
  ``DeviceMesh`` as ``DTensor``s, synced by in-place reductions;
* :class:`InGraphTransport` (``in_graph.py``): the JAX package's in-graph
  backend by name; the port has no traced collective, so it delegates to the
  eager pair.
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
from metrics_tpu_torch.transport.in_graph import InGraphTransport  # noqa: F401
from metrics_tpu_torch.transport.gather import (  # noqa: F401
    GatherTransport,
    StoreSubgroupChannel,
    consume_subgroup_round,
    kvstore_subgroup_allgather,
    maybe_register_kvstore_channel,
    set_subgroup_allgather,
    subgroup_allgather,
)
from metrics_tpu_torch.transport.loopback import LoopbackTransport  # noqa: F401
from metrics_tpu_torch.transport.sharded import ShardedTransport, tenant_sharding  # noqa: F401
