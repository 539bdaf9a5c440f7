"""ExplainedVariance module metric.

Counterpart of ``metrics_tpu/regression/explained_variance.py``: four
float32 moment sums (scalars, or ``(num_outputs,)`` once a 2-D batch lands,
as in the JAX package) and an int64 ``n_obs`` count, all ``"sum"``.
"""
from typing import Any, Callable, Optional, Sequence, Union

import torch

from metrics_tpu_torch.functional.regression.explained_variance import (
    _explained_variance_compute,
    _explained_variance_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor

_MOMENTS = ("sum_error", "sum_squared_error", "sum_target", "sum_squared_target")


class ExplainedVariance(Metric):
    """Explained variance from streaming moment sums.

    Args:
        multioutput: ``'raw_values' | 'uniform_average' | 'variance_weighted'``.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
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
        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}"
            )
        self.multioutput = multioutput
        for name in _MOMENTS:
            self.add_state(name, default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("n_obs", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the five moment sums."""
        n_obs, *moments = _explained_variance_update(preds, target)
        self.n_obs = self.n_obs + n_obs
        for name, value in zip(_MOMENTS, moments):
            state = getattr(self, name)
            setattr(self, name, state + value.to(state.dtype))

    def compute(self) -> Union[Tensor, Sequence[Tensor]]:
        """Explained variance over everything seen so far."""
        return _explained_variance_compute(
            self.n_obs,
            self.sum_error,
            self.sum_squared_error,
            self.sum_target,
            self.sum_squared_target,
            self.multioutput,
        )
