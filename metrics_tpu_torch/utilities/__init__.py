"""Helpers shared by the metrics (counterpart of ``metrics_tpu/utilities/``).

The package exports the JAX package's thirteen names
(``metrics_tpu/utilities/__init__.py``). Two of them differ:
:func:`hierarchical_axis` builds a :class:`Hierarchy` of process groups
where the JAX package names mesh axes, and :func:`shard_map_compat` raises,
since the port has no ``shard_map``.
"""
from metrics_tpu_torch.utilities.data import apply_to_collection  # noqa: F401
from metrics_tpu_torch.utilities.distributed import (  # noqa: F401
    Hierarchy,
    applied_transport_overrides,
    class_reduce,
    current_transport_overrides,
    hierarchical_axis,
    reduce,
    shard_map_compat,
    transport_overrides,
)
from metrics_tpu_torch.utilities.prints import (  # noqa: F401
    rank_zero_debug,
    rank_zero_info,
    rank_zero_only,
    rank_zero_warn,
)
