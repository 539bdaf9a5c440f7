"""HammingDistance module metric.

Counterpart of ``metrics_tpu/classification/hamming_distance.py``: two
scalar int32 sum states, ``correct`` and ``total``.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.hamming_distance import (
    _hamming_distance_compute,
    _hamming_distance_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor


class HammingDistance(Metric):
    """Average fraction of per-label disagreements between preds and target.

    Args:
        threshold: probability cutoff binarizing float predictions.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(
        self,
        threshold: float = 0.5,
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
        self.add_state("correct", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

        if not 0 < threshold < 1:
            raise ValueError(f"The `threshold` should be a float in the (0,1) interval, got {threshold}")
        self.threshold = threshold

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate correct/total label counts from a batch."""
        correct, total = _hamming_distance_update(preds, target, self.threshold)
        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> Tensor:
        """Hamming distance over everything seen so far."""
        return _hamming_distance_compute(self.correct, self.total)
