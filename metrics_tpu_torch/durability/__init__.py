"""Durability plane: the state lifecycle between serving and transport.

Counterpart of ``metrics_tpu/durability/__init__.py``, with the same
exports:

* **Incremental checkpointing**
  (:mod:`~metrics_tpu_torch.durability.checkpoint`) —
  :class:`CheckpointManager` writes mergeable snapshots in the JAX
  package's on-disk format with a manifest + atomic-rename protocol, delta
  saves stamping only the tenants touched since the last save, and
  asynchronous saves on the background engine's ``"durability"`` lane;
* **Topology-flexible restore** — another capacity, another device, or a
  transport's ``place_state``;
* **Elastic capacity + cold-tenant spill** — ``KeyedMetric.grow``/``compact``
  and :class:`TenantSpiller`, which evicts idle tenants' rows to host memory
  and faults them back on their next update or read with exact
  conservation (``resident_active + spilled == active``).

The ``durability.*`` telemetry family
(:mod:`~metrics_tpu_torch.durability.telemetry`) surfaces in
``observability.snapshot()["durability"]``, the
``metrics_tpu_durability_*`` Prometheus series, ``durability`` timeline
events and the save/restore/fault-back histograms.
"""
from metrics_tpu_torch.durability.checkpoint import (  # noqa: F401
    CheckpointCrash,
    CheckpointError,
    CheckpointManager,
    inject_crash,
    restore_checkpoint,
    save_checkpoint,
)
from metrics_tpu_torch.durability.spill import TenantSpiller  # noqa: F401
from metrics_tpu_torch.durability.telemetry import (  # noqa: F401
    DURABILITY_STATS,
    DurabilityStats,
    summary,
)

__all__ = [
    "CheckpointCrash",
    "CheckpointError",
    "CheckpointManager",
    "DURABILITY_STATS",
    "DurabilityStats",
    "TenantSpiller",
    "inject_crash",
    "restore_checkpoint",
    "save_checkpoint",
    "summary",
]
