"""Precision and Recall module metrics.

Counterpart of ``metrics_tpu/classification/precision_recall.py``:
StatScores subclasses whose ``compute`` applies the precision/recall
reductions to the accumulated counts.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.precision_recall import _precision_compute, _recall_compute
from metrics_tpu_torch.utilities.data import Tensor


class Precision(StatScores):
    """``tp / (tp + fp)`` accumulated over batches.

    Shares the stat-scores engine (and its argument set) with
    :class:`~metrics_tpu_torch.Accuracy` — see that class for the full description
    of ``threshold`` / ``num_classes`` / ``average`` / ``mdmc_average`` /
    ``ignore_index`` / ``top_k`` / ``multiclass``. ``average`` additionally
    affects zero-division handling: classes with no predicted positives
    score 0 and, under ``"weighted"``/``"macro"``, classes that never appear
    are dropped from the mean.
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
        """Precision over everything seen so far."""
        tp, fp, _, fn = self._get_final_stats()
        return _precision_compute(tp, fp, fn, self.average, self.mdmc_reduce)


class Recall(StatScores):
    """``tp / (tp + fn)`` accumulated over batches.

    Shares the stat-scores engine (and its argument set) with
    :class:`~metrics_tpu_torch.Accuracy`; see :class:`~metrics_tpu_torch.Precision` for
    the zero-division conventions (here: classes with no true positives +
    false negatives).
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
        """Recall over everything seen so far."""
        tp, fp, _, fn = self._get_final_stats()
        return _recall_compute(tp, fp, fn, self.average, self.mdmc_reduce)
