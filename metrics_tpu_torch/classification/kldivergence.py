"""KLDivergence module metric.

Counterpart of ``metrics_tpu/classification/kldivergence.py``: a float32
sum state for the mean/sum reductions, a ``"cat"`` list state for
``'none'``, and an int64 row count.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.kldivergence import _kld_compute, _kld_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat


class KLDivergence(Metric):
    """KL divergence accumulated over batches.

    Args:
        log_prob: inputs are log-probabilities (already normalized).
        reduction: ``'mean' | 'sum' | 'none' | None``.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = True

    def __init__(
        self,
        log_prob: bool = False,
        reduction: Optional[str] = "mean",
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
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        self.log_prob = log_prob

        allowed_reduction = ("mean", "sum", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction

        if self.reduction in ("mean", "sum"):
            self.add_state("measures", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        else:
            self.add_state("measures", default=[], dist_reduce_fx="cat")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, p: Tensor, q: Tensor) -> None:
        """Accumulate per-row KL measures."""
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction is None or self.reduction == "none":
            self.measures.append(measures)
        else:
            self.measures = self.measures + torch.sum(measures)
        self.total = self.total + total

    def compute(self) -> Tensor:
        """KL divergence over everything seen so far."""
        measures = dim_zero_cat(self.measures) if self.reduction in ("none", None) else self.measures
        return _kld_compute(measures, self.total, self.reduction)
