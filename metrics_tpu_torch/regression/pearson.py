"""PearsonCorrcoef module metric.

Counterpart of ``metrics_tpu/regression/pearson.py``: the list mode buffers
every pair (``"cat"``); ``streaming=True`` keeps an int32 ``n_total`` and
five float64 co-moment sums (the JAX package's float64 when x64 is on; the
card computes float64 natively), a fixed-shape state that the compiled step
threads, one sum syncs and a keyed update routes (the float64 leaves by the
plain ``index_add_``, ``n_total`` through the segment-scatter kernel).
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.regression.pearson import (
    _pearson_check,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat

_MOMENTS = ("sum_x", "sum_y", "sum_xx", "sum_yy", "sum_xy")


class PearsonCorrcoef(Metric):
    """Pearson correlation over all seen (preds, target) pairs.

    Args:
        streaming: accumulate co-moment sums instead of buffering samples:
            constant memory, fixed-shape state.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = True

    def __init__(
        self,
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
        self.streaming = streaming
        if streaming:
            self.add_state("n_total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
            for name in _MOMENTS:
                self.add_state(name, default=torch.zeros((), dtype=torch.float64), dist_reduce_fx="sum")
        else:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append the batch pairs, integers as float32 (or fold them into the
        float64 co-moment sums, integers converted straight to float64)."""
        if self.streaming:
            preds, target = _pearson_check(preds, target)
            x = torch.atleast_1d(preds).to(self.sum_x.dtype)
            y = torch.atleast_1d(target).to(self.sum_y.dtype)
            self.n_total = self.n_total + x.numel()
            self.sum_x = self.sum_x + torch.sum(x)
            self.sum_y = self.sum_y + torch.sum(y)
            self.sum_xx = self.sum_xx + torch.sum(x * x)
            self.sum_yy = self.sum_yy + torch.sum(y * y)
            self.sum_xy = self.sum_xy + torch.sum(x * y)
        else:
            preds, target = _pearson_corrcoef_update(preds, target)
            self.preds.append(preds)
            self.target.append(target)

    def compute(self) -> Tensor:
        """Pearson correlation over everything seen so far."""
        if self.streaming:
            dtype = self.sum_xy.dtype
            n = torch.clamp(self.n_total, min=1).to(dtype)
            mean_x = self.sum_x / n
            mean_y = self.sum_y / n
            cov = self.sum_xy / n - mean_x * mean_y
            var_x = self.sum_xx / n - mean_x**2
            var_y = self.sum_yy / n - mean_y**2
            # a variance below the cancellation noise of its raw second moment
            # is numerically zero -> correlation 0 (the buffered path's
            # eps-guarded-denominator semantics)
            eps = 1e-12 if dtype == torch.float64 else 1e-6
            degenerate = (var_x <= eps * torch.abs(self.sum_xx / n)) | (var_y <= eps * torch.abs(self.sum_yy / n))
            denom = torch.sqrt(torch.clamp(var_x, min=0) * torch.clamp(var_y, min=0))
            safe = torch.where(degenerate, torch.ones_like(denom), denom)
            corr = torch.where(degenerate, torch.zeros_like(cov), cov / safe)
            return torch.clamp(corr, -1.0, 1.0).to(dtype)

        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _pearson_corrcoef_compute(preds, target)
