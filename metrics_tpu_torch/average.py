"""Weighted running mean of a stream of values.

Counterpart of ``metrics_tpu/average.py`` (``AverageMeter``): sum-reduced
float32 ``value``/``weight`` states, the weights broadcast to the values.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor


class AverageMeter(Metric):
    """Computes the (weighted) average of a stream of values.

    Example::

        >>> import torch
        >>> from metrics_tpu_torch import AverageMeter
        >>> avg = AverageMeter(device="cpu")
        >>> avg.update(3)
        >>> avg.update(1)
        >>> float(avg.compute())
        2.0
    """

    is_differentiable = True

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.add_state("value", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("weight", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, value: Union[Tensor, float], weight: Union[Tensor, float] = 1.0) -> None:
        """Accumulate observations ``value`` with per-observation ``weight``
        (broadcast to ``value``'s shape)."""
        value = torch.as_tensor(value, dtype=torch.float32, device=self.device)
        if isinstance(weight, Tensor):
            weight = weight.to(dtype=torch.float32).broadcast_to(value.shape)
        else:  # a fill on the device, where a tensor of the number would be a copy to it
            weight = torch.full(value.shape, float(weight), dtype=torch.float32, device=self.device)
        self.value = self.value + torch.sum(value * weight)
        self.weight = self.weight + torch.sum(weight)

    def compute(self) -> Tensor:
        return self.value / self.weight
