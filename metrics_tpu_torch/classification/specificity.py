"""Specificity module metric.

Counterpart of ``metrics_tpu/classification/specificity.py``: a StatScores
subclass, so with ``average="macro"`` it shares its class key (one B1 launch
per batch) with macro Precision, Recall and F1 in a MetricCollection.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.specificity import _specificity_compute
from metrics_tpu_torch.utilities.data import Tensor


class Specificity(StatScores):
    """``tn / (tn + fp)`` accumulated over batches.

    Shares the stat-scores engine (and its argument set) with
    :class:`~metrics_tpu_torch.Accuracy`; classes with no true negatives +
    false positives score 0 under the averaged modes.
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: str = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        allowed_average = ["micro", "macro", "weighted", "samples", "none", None]
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

        super().__init__(
            reduce="macro" if average in ["weighted", "none", None] else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.average = average

    def compute(self) -> Tensor:
        """Specificity over everything seen so far."""
        tp, fp, tn, fn = self._get_final_stats()
        return _specificity_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)
