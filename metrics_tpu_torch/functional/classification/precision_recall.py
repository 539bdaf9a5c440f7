"""Precision and recall.

Counterpart of ``metrics_tpu/functional/classification/precision_recall.py``.
Classes with no tp/fp/fn are flagged "meaningless" for ``average="none"``.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import (
    _check_average_arg,
    _reduce_stat_scores,
    _stat_scores_update,
)
from metrics_tpu_torch.utilities.data import Tensor
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod


def _mask_meaningless(numerator: Tensor, denominator: Tensor, tp: Tensor, fp: Tensor, fn: Tensor) -> Tuple[Tensor, Tensor]:
    """Flag classes absent from both preds and target (-1 -> ignored downstream)."""
    meaningless = (tp | fn | fp) == 0
    return torch.where(meaningless, -1, numerator), torch.where(meaningless, -1, denominator)


def _precision_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    numerator = tp
    denominator = tp + fp
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        numerator, denominator = _mask_meaningless(numerator, denominator, tp, fp, fn)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _recall_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    numerator = tp
    denominator = tp + fn
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        numerator, denominator = _mask_meaningless(numerator, denominator, tp, fp, fn)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def precision(
    preds: Tensor,
    target: Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """``tp / (tp + fp)`` with micro/macro/weighted/samples averaging.
    """
    _check_average_arg(average, mdmc_average, num_classes, ignore_index)

    reduce = "macro" if average in ["weighted", "none", None] else average
    tp, fp, _, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _precision_compute(tp, fp, fn, average, mdmc_average)


def recall(
    preds: Tensor,
    target: Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """``tp / (tp + fn)`` with micro/macro/weighted/samples averaging.
    """
    _check_average_arg(average, mdmc_average, num_classes, ignore_index)

    reduce = "macro" if average in ["weighted", "none", None] else average
    tp, fp, _, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _recall_compute(tp, fp, fn, average, mdmc_average)


def precision_recall(
    preds: Tensor,
    target: Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[Tensor, Tensor]:
    """Both precision and recall from a single stat-scores pass.
    """
    _check_average_arg(average, mdmc_average, num_classes, ignore_index)

    reduce = "macro" if average in ["weighted", "none", None] else average
    tp, fp, _, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return (
        _precision_compute(tp, fp, fn, average, mdmc_average),
        _recall_compute(tp, fp, fn, average, mdmc_average),
    )
