"""ShardedTransport: metric state sharded on a device mesh.

Counterpart of ``metrics_tpu/transport/sharded.py:42-270``, over a
``torch.distributed.device_mesh.DeviceMesh`` and ``DTensor``s: a state
leaf's leading axis (class, tenant or feature rows) is split ``Shard(0)``
over the mesh's ``shard_axis``, so N devices each hold ``1/N`` of a giant
leaf; a leaf whose leading dim does not divide stays ``Replicate()``.

* :meth:`ShardedTransport.shard_state` places a state dict on the mesh,
  :meth:`ShardedTransport.adopt` points a metric at the transport and moves
  its states, and :meth:`ShardedTransport.place_state` is the restore seam
  (a checkpoint saved replicated restores sharded, and the reverse, without
  the snapshot knowing either topology);
* **sync** is the in-place sharded reduction: the elementwise-reduced leaves
  ("sum"/"mean"/"max"/"min") are reduced across the ``replica_axis`` of the
  mesh in place on each local shard, one ``all_reduce`` per leaf over that
  mesh dimension's group; with ``replica_axis=None`` each leaf is already
  the global state and the reduction is the identity;
* every other leaf rides the eager gather (``eager``, default the auto
  loopback/gather pair), inheriting its subgroup formation.

On one card the mesh has one device: ``Shard(0)`` holds the whole leaf, and
the round trips equal the replicated state.
"""
from typing import Any, Dict, List, Optional, Sequence

import torch

from metrics_tpu_torch.transport.base import Transport

__all__ = ["ShardedTransport", "tenant_sharding"]

#: reductions the in-place sharded path reduces elementwise
_ELEMENTWISE = ("sum", "mean", "max", "min")


def tenant_sharding(mesh: Any, shard_axis: str) -> List[Any]:
    """The ``DTensor`` placements that split a tenant-stacked leaf's leading
    axis over ``shard_axis`` of ``mesh`` and replicate it over every other
    mesh dimension (the counterpart of ``NamedSharding(mesh, P(axis))``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    if shard_axis not in names:
        raise ValueError(f"mesh {names} has no axis {shard_axis!r}")
    return [Shard(0) if name == shard_axis else Replicate() for name in names]


class ShardedTransport(Transport):
    """Transport whose state leaves live sharded across the devices of
    ``mesh`` (a ``DeviceMesh`` with named dimensions).

    ``shard_axis`` names the mesh dimension the leading dimension is split
    over; ``replica_axis`` optionally names one holding per-replica PARTIAL
    states, which a sync reduces in place; ``eager`` overrides the fallback
    transport of the other leaves.
    """

    name = "sharded"

    def __init__(self, mesh: Any, shard_axis: str, *, replica_axis: Optional[str] = None,
                 eager: Optional[Transport] = None) -> None:
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if shard_axis not in names:
            raise ValueError(f"mesh {names} has no axis {shard_axis!r}")
        if replica_axis is not None and replica_axis not in names:
            raise ValueError(f"mesh {names} has no axis {replica_axis!r}")
        if eager is not None and not isinstance(eager, Transport):
            raise TypeError(f"eager must be a Transport, got {eager!r}")
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.replica_axis = replica_axis
        self._eager_override = eager

    # -- placement ---------------------------------------------------------

    def _axis_size(self, axis: str) -> int:
        return int(self.mesh.size(self.mesh.mesh_dim_names.index(axis)))

    def sharding_for(self, leaf: Any) -> List[Any]:
        """The placements this transport gives ``leaf``: the leading axis
        split over ``shard_axis`` when it divides that axis' size, replicated
        otherwise."""
        from torch.distributed.tensor import Replicate

        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) >= 1 and shape[0] > 0 and shape[0] % self._axis_size(self.shard_axis) == 0:
            return tenant_sharding(self.mesh, self.shard_axis)
        return [Replicate() for _ in self.mesh.mesh_dim_names]

    def _place(self, value: torch.Tensor) -> Any:
        from torch.distributed.tensor import DTensor, distribute_tensor

        if isinstance(value, DTensor):
            value = value.full_tensor()
        return distribute_tensor(value.to(self.mesh.device_type), self.mesh, self.sharding_for(value))

    def shard_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Every tensor leaf of ``state`` placed on the mesh (a list state's
        elements replicated: the gather fallback owns them)."""
        out: Dict[str, Any] = {}
        for name, value in state.items():
            if isinstance(value, (list, tuple)):
                out[name] = [self._place(torch.as_tensor(v)) for v in value]
            else:
                out[name] = self._place(torch.as_tensor(value))
        return out

    def adopt(self, metric: Any) -> Any:
        """Point ``metric`` at this transport and move its live states onto
        the mesh. Returns the metric."""
        metric.set_transport(self)
        metric._set_states(self.shard_state(metric._get_states()))
        return metric

    def place_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Restore-time placement: every leaf sharded over the mesh."""
        return self.shard_state(state)

    # -- eager sync: in-place sharded reduction ----------------------------

    def reduce_states(self, states: Dict[str, Any], reductions: Dict[str, Any],
                      group: Optional[Any] = None) -> Optional[Dict[str, Any]]:
        """The elementwise leaves reduced across ``replica_axis`` in place on
        their local shards (the identity without one); ``None`` when no leaf
        is elementwise. The caller gathers the rest."""
        handled = [name for name, value in states.items()
                   if not isinstance(value, (list, tuple)) and reductions.get(name) in _ELEMENTWISE]
        if not handled:
            return None
        sub = {name: states[name] for name in handled}
        if self.replica_axis is None:
            self._note_reduce(sub, identity=True)
            return sub
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor

        group = self.mesh.get_group(self.replica_axis)
        ops = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
        replicas = self._axis_size(self.replica_axis)
        for name, leaf in sub.items():
            local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            dist.all_reduce(local, op=ops[reductions[name]], group=group)
            if reductions[name] == "mean":
                local.div_(replicas)
        self._note_reduce(sub, identity=False)
        return sub

    def _note_reduce(self, sub: Dict[str, Any], *, identity: bool) -> None:
        """One in-place sharded sync into the sync record: a zero-byte round
        labelled ``sharded`` (``sharded_reduce`` across replicas) spanning
        every process, so it never counts as a subgroup round."""
        from metrics_tpu_torch.observability.registry import TELEMETRY
        from metrics_tpu_torch.utilities.distributed import world_size

        if not TELEMETRY.enabled:
            return
        everyone = list(range(max(world_size(), 1)))
        TELEMETRY.record_gather(
            bytes_out=0, bytes_in=0, transport_bytes=0, descriptor_rounds=1, payload_rounds=0,
            world=len(everyone), members=everyone, leaves=len(sub),
            transport=self.name if identity else f"{self.name}_reduce", participants=everyone,
        )

    # -- delegation for everything else ------------------------------------

    def gather_pytrees(self, trees: List[Any], group: Optional[Any] = None) -> List[Any]:
        return self._eager().gather_pytrees(trees, group=group)

    def gather_array(self, result: Any, group: Optional[Any] = None) -> List[Any]:
        return self._eager().gather_array(result, group=group)

    def subgroup(self, members: Sequence[int]) -> Transport:
        sub = self._eager().subgroup(members)
        if sub is self._eager():
            return self
        return ShardedTransport(self.mesh, self.shard_axis, replica_axis=self.replica_axis, eager=sub)

    def _eager(self) -> Transport:
        if self._eager_override is not None:
            return self._eager_override
        from metrics_tpu_torch.transport.base import _AUTO

        return _AUTO._eager()

    def max_shard_fraction(self, leaf: Any) -> float:
        """The largest fraction of ``leaf``'s bytes one device of this process
        holds: ``1 / shards`` for a sharded leaf, 1.0 for a replicated or
        plain one."""
        from torch.distributed.tensor import DTensor

        if not isinstance(leaf, DTensor) or leaf.numel() == 0:
            return 1.0
        return leaf.to_local().numel() / leaf.numel()
