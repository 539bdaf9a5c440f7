"""Cross-process gather for the epoch-end state sync.

Counterpart of the eager gather in ``metrics_tpu/utilities/distributed.py``
(``distributed_available`` and ``gather_all_arrays``), over
``torch.distributed``: tensors whose shapes differ across processes (a
``"cat"`` state after ragged batches) are padded to the largest shape for the
collective and trimmed back after it.
"""
from typing import Any, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def distributed_available() -> bool:
    """True when a process group with more than one process is initialised."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def gather_all_tensors(result: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
    """``result`` from every process of ``group`` (default: the world), in rank order."""
    if group is None:
        group = dist.group.WORLD
    result = result.contiguous()
    world_size = dist.get_world_size(group)
    if result.ndim == 0:
        gathered = [torch.zeros_like(result) for _ in range(world_size)]
        dist.all_gather(gathered, result, group=group)
        return gathered

    local_size = torch.tensor(result.shape, device=result.device)
    sizes = [torch.zeros_like(local_size) for _ in range(world_size)]
    dist.all_gather(sizes, local_size, group=group)
    max_size = torch.stack(sizes).amax(dim=0)

    pad: List[int] = []
    for dim in reversed(range(result.ndim)):
        pad += [0, int(max_size[dim]) - result.shape[dim]]
    padded = F.pad(result, pad)
    gathered = [torch.zeros_like(padded) for _ in range(world_size)]
    dist.all_gather(gathered, padded, group=group)
    return [g[tuple(slice(0, int(d)) for d in size)] for g, size in zip(gathered, sizes)]
