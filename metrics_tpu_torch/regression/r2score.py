"""R2Score module metric.

Counterpart of ``metrics_tpu/regression/r2score.py``: three
``(num_outputs,)`` float32 moment sums and an int64 ``total`` count, all
``"sum"``.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.regression.r2score import _r2score_compute, _r2score_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor


class R2Score(Metric):
    """R2 score from streaming moment sums, ``(num_outputs,)``-shaped states.

    Args:
        num_outputs: regression target dimensionality.
        adjusted: degrees of freedom for the adjusted-R2 penalty (0 = plain).
        multioutput: ``'uniform_average'`` | ``'raw_values'`` |
            ``'variance_weighted'`` combination of per-output scores.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        num_outputs: int = 1,
        adjusted: int = 0,
        multioutput: str = "uniform_average",
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
        self.num_outputs = num_outputs

        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted

        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}"
            )
        self.multioutput = multioutput

        for name in ("sum_squared_error", "sum_error", "residual"):
            self.add_state(name, default=torch.zeros(num_outputs, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the moment sums."""
        sum_squared_error, sum_error, residual, total = _r2score_update(preds, target)
        dtype = self.residual.dtype
        self.sum_squared_error = self.sum_squared_error + sum_squared_error.to(dtype)
        self.sum_error = self.sum_error + sum_error.to(dtype)
        self.residual = self.residual + residual.to(dtype)
        self.total = self.total + total

    def compute(self) -> Tensor:
        """R2 score over everything seen so far."""
        return _r2score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )
