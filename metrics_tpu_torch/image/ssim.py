"""SSIM module metric.

Counterpart of ``metrics_tpu/image/ssim.py``. Like the JAX package it
buffers every prediction and target (``"cat"`` states), so the epoch's
compute can find a global ``data_range``. ``streaming=True`` (which needs an
explicit ``data_range`` and ``'elementwise_mean'``/``'sum'``) reduces each
batch's SSIM map on arrival into a float64 ``ssim_sum`` and ``n_elements``
(the JAX package's float64 when x64 is on): two scalars, a fixed-shape state
that the compiled step threads.
"""
from typing import Any, Callable, Optional, Sequence, Union

import torch

from metrics_tpu_torch.functional.regression.ssim import _ssim_compute, _ssim_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat
from metrics_tpu_torch.utilities.prints import rank_zero_warn


class SSIM(Metric):
    """Structural similarity index measure.

    Args:
        kernel_size: size of the gaussian window
        sigma: standard deviation of the gaussian window
        reduction: ``'elementwise_mean'`` | ``'sum'`` | ``'none'``
        data_range: range of the image; if None determined from the data
        k1: SSIM stability constant (luminance)
        k2: SSIM stability constant (contrast)
        streaming: reduce each batch on arrival into a running sum and count
            (needs ``data_range`` and a mean/sum reduction): O(1) memory,
            fixed-shape state
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: str = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        streaming: bool = False,
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
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.reduction = reduction
        self.streaming = streaming

        if streaming:
            if data_range is None:
                raise ValueError("`streaming=True` requires an explicit `data_range`")
            if reduction not in ("elementwise_mean", "sum"):
                raise ValueError("`streaming=True` requires reduction 'elementwise_mean' or 'sum'")
            self.add_state("ssim_sum", default=torch.zeros((), dtype=torch.float64), dist_reduce_fx="sum")
            self.add_state("n_elements", default=torch.zeros((), dtype=torch.float64), dist_reduce_fx="sum")
        else:
            rank_zero_warn(
                "Metric `SSIM` will save all targets and"
                " predictions in buffer. For large datasets this may lead"
                " to large memory footprint."
            )
            self.add_state("y", default=[], dist_reduce_fx="cat")
            self.add_state("y_pred", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Buffer this batch (or reduce it into the running sums)."""
        preds, target = _ssim_update(preds, target)
        if self.streaming:
            # the per-pixel map, so the count is exactly the cropped map's size
            ssim_map = _ssim_compute(
                preds, target, self.kernel_size, self.sigma, "none", self.data_range, self.k1, self.k2
            )
            self.ssim_sum = self.ssim_sum + torch.sum(ssim_map).to(self.ssim_sum.dtype)
            self.n_elements = self.n_elements + float(ssim_map.numel())
        else:
            self.y_pred.append(preds)
            self.y.append(target)

    def compute(self) -> Tensor:
        """SSIM over all images seen so far."""
        if self.streaming:
            if self.reduction == "sum":
                return self.ssim_sum.to(torch.float32)
            return (self.ssim_sum / torch.clamp(self.n_elements, min=1.0)).to(torch.float32)

        preds = dim_zero_cat(self.y_pred)
        target = dim_zero_cat(self.y)
        return _ssim_compute(
            preds, target, self.kernel_size, self.sigma, self.reduction, self.data_range, self.k1, self.k2
        )
