"""CosineSimilarity module metric.

Counterpart of ``metrics_tpu/regression/cosine_similarity.py``: the list
mode buffers every pair (``"cat"``); ``streaming=True`` (for ``'sum'`` and
``'mean'``) folds each batch's per-row similarities into a float32
``sim_sum`` and an int32 ``n_total`` count, a fixed-shape state that the
compiled step threads and one sum syncs.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.regression.cosine_similarity import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat


class CosineSimilarity(Metric):
    """Row-wise cosine similarity over all seen pairs.

    Args:
        reduction: ``'sum' | 'mean' | 'none'``.
        streaming: accumulate the reduced value instead of buffering samples
            (``'sum'``/``'mean'`` only): constant memory, fixed-shape state.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = True

    def __init__(
        self,
        reduction: Optional[str] = "sum",
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
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.streaming = streaming

        if streaming:
            if reduction not in ("sum", "mean"):
                raise ValueError("`streaming=True` requires reduction 'sum' or 'mean'")
            self.add_state("sim_sum", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state("n_total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        else:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append the batch pairs (or fold their summed similarity in)."""
        preds, target = _cosine_similarity_update(preds, target)
        if self.streaming:
            self.sim_sum = self.sim_sum + _cosine_similarity_compute(preds, target, "sum").to(self.sim_sum.dtype)
            # one similarity value per vector (everything but the feature axis)
            self.n_total = self.n_total + preds[..., 0].numel()
        else:
            self.preds.append(preds)
            self.target.append(target)

    def compute(self) -> Tensor:
        """Cosine similarity over everything seen so far."""
        if self.streaming:
            if self.reduction == "mean":
                return self.sim_sum / torch.clamp(self.n_total, min=1)
            return self.sim_sum

        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _cosine_similarity_compute(preds, target, self.reduction)
