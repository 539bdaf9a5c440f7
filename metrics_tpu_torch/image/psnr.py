"""PSNR module metric.

Counterpart of ``metrics_tpu/image/psnr.py``. Without ``dim``: a float32
``sum_squared_error`` sum and an int64 ``total`` count; with ``dim`` both
are lists of per-batch tensors. Without ``data_range`` the running
``min_target``/``max_target`` states reduce with ``"min"``/``"max"`` (so a
keyed ``PSNR()`` routes them through the extremal segment-scatter kernel);
with it, ``data_range`` is a ``"mean"`` state.
"""
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.regression.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat
from metrics_tpu_torch.utilities.prints import rank_zero_warn


class PSNR(Metric):
    r"""Peak signal-to-noise ratio:
    :math:`\text{PSNR}(I, J) = 10 \log_{10}\!\left(\max(I)^2 / \text{MSE}(I, J)\right)`.

    Args:
        data_range: the range of the data; if None it is determined from the
            running min/max of ``target``. Must be given when ``dim`` is set.
        base: logarithm base
        reduction: ``'elementwise_mean'`` | ``'sum'`` | ``'none'``
        dim: dimension(s) to reduce PSNR scores over; None reduces over all
            dimensions and batches.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: str = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
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

        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[])
            self.add_state("total", default=[])

        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="min")
            self.add_state("max_target", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="max")
        else:
            self.add_state("data_range", default=torch.tensor(float(data_range)), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate squared-error sums (and the running target min/max)."""
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                # running min/max of target; the initial 0.0 takes part, as
                # in the JAX package
                self.min_target = torch.minimum(target.min().to(self.min_target.dtype), self.min_target)
                self.max_target = torch.maximum(target.max().to(self.max_target.dtype), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error.to(self.sum_squared_error.dtype)
            self.total = self.total + n_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(n_obs)

    def compute(self) -> Tensor:
        """PSNR over everything seen so far."""
        data_range = self.data_range if self.data_range is not None else self.max_target - self.min_target
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = dim_zero_cat([v.reshape(-1) for v in self.sum_squared_error])
            total = dim_zero_cat([torch.as_tensor(v).reshape(-1) for v in self.total])
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)
