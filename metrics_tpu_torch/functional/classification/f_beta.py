"""F-beta / F1.

Counterpart of ``metrics_tpu/functional/classification/f_beta.py``:
micro-averaged stats mask ignored classes (flagged ``-1``); per-class scores
ignore classes absent from both preds and target.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.stat_scores import (
    _check_average_arg,
    _reduce_stat_scores,
    _stat_scores_update,
)
from metrics_tpu_torch.utilities.data import Tensor
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod


def _safe_divide(num: Tensor, denom: Tensor) -> Tensor:
    """Division that returns 0 where the denominator is 0."""
    return num / torch.where(denom == 0, 1.0, denom)


def _fbeta_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    if average == AverageMethod.MICRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        mask = tp >= 0  # classes deleted by ignore_index are flagged -1
        tp_sum = torch.sum(torch.where(mask, tp, 0)).float()
        fp_sum = torch.sum(torch.where(mask, fp, 0)).float()
        fn_sum = torch.sum(torch.where(mask, fn, 0)).float()
        precision = _safe_divide(tp_sum, tp_sum + fp_sum)
        recall = _safe_divide(tp_sum, tp_sum + fn_sum)
    else:
        precision = _safe_divide(tp.float(), (tp + fp).float())
        recall = _safe_divide(tp.float(), (tp + fn).float())

    num = (1 + beta**2) * precision * recall
    denom = beta**2 * precision + recall
    denom = torch.where(denom == 0.0, 1.0, denom)

    # build the ignore mask: explicitly ignored class + (for average='none')
    # classes absent from preds and target (reference: f_beta.py:52-68)
    ignore_mask = None
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        ignore_mask = (tp | fn | fp) == 0
        if ignore_index is not None:
            ignore_mask = ignore_mask.clone()
            ignore_mask[ignore_index] = True
    elif ignore_index is not None and average not in (AverageMethod.MICRO, AverageMethod.SAMPLES):
        ignore_mask = torch.zeros(num.shape[-1] if mdmc_average == MDMCAverageMethod.SAMPLEWISE else num.shape[0],
                                  dtype=torch.bool, device=num.device)
        ignore_mask[ignore_index] = True
        if mdmc_average != MDMCAverageMethod.SAMPLEWISE and num.ndim > 1:
            ignore_mask = ignore_mask.reshape((-1,) + (1,) * (num.ndim - 1))

    if ignore_mask is not None:
        num = torch.where(ignore_mask, -1.0, num)
        denom = torch.where(ignore_mask, -1.0, denom)

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """F-beta: ``(1 + beta^2) * P * R / (beta^2 * P + R)``.
    """
    _check_average_arg(average, mdmc_average, num_classes, ignore_index)

    reduce = "macro" if average in ["weighted", "none", None] else average
    tp, fp, tn, fn = _stat_scores_update(
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
    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """F1 = harmonic mean of precision and recall (F-beta with ``beta=1``).
    """
    return fbeta(
        preds, target, 1.0, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )
