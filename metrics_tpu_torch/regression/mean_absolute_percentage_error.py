"""MeanAbsolutePercentageError module metric.

Counterpart of ``metrics_tpu/regression/mean_absolute_percentage_error.py``:
a float32 ``sum_abs_per_error`` sum and an int64 ``total`` count, both
``"sum"``.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.regression.mean_absolute_percentage_error import (
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor


class MeanAbsolutePercentageError(Metric):
    """MAPE accumulated over batches.

    Args:
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = True
    higher_is_better = False

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
        self.add_state("sum_abs_per_error", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate this batch's sum."""
        sum_abs_per_error, n_obs = _mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + sum_abs_per_error.to(self.sum_abs_per_error.dtype)
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        """The value over everything seen so far."""
        return _mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)
