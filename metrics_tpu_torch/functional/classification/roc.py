"""Receiver operating characteristic.

Counterpart of ``metrics_tpu/functional/classification/roc.py``: the (0, 0)
curve start, fpr/tpr from the shared sort-scan
(:func:`~metrics_tpu_torch.functional.classification.precision_recall_curve._binary_clf_curve`),
per-class recursion for multiclass and multilabel inputs. Eager epoch-end
math, like the precision-recall curve.
"""
from typing import Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    CurveOutput,
    _binary_clf_curve,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.utilities.data import Tensor, to_host


def _roc_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[Tensor, Tensor, int, int]:
    return _precision_recall_curve_update(preds, target, num_classes, pos_label)


def _roc_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> CurveOutput:
    if num_classes == 1 and preds.ndim == 1:  # binary
        fps, tps, thresholds = _binary_clf_curve(
            preds=preds, target=target, sample_weights=sample_weights, pos_label=pos_label
        )
        # extra threshold so the curve starts at (0, 0)
        tps = torch.cat([torch.zeros(1, dtype=tps.dtype, device=tps.device), tps])
        fps = torch.cat([torch.zeros(1, dtype=fps.dtype, device=fps.device), fps])
        thresholds = torch.cat([thresholds[:1] + 1, thresholds])

        fps_last, tps_last = to_host(torch.stack([fps[-1], tps[-1]]))
        if fps_last <= 0:
            raise ValueError("No negative samples in targets, false positive value should be meaningless")
        fpr = fps / fps[-1]

        if tps_last <= 0:
            raise ValueError("No positive samples in targets, true positive value should be meaningless")
        tpr = tps / tps[-1]

        return fpr, tpr, thresholds

    # per-class recursion
    fpr, tpr, thresholds = [], [], []
    for c in range(num_classes):
        if preds.shape == target.shape:
            preds_c, target_c, pos_label_c = preds[:, c], target[:, c], 1
        else:
            preds_c, target_c, pos_label_c = preds[:, c], target, c
        res = roc(preds=preds_c, target=target_c, num_classes=1, pos_label=pos_label_c, sample_weights=sample_weights)
        fpr.append(res[0])
        tpr.append(res[1])
        thresholds.append(res[2])
    return fpr, tpr, thresholds


def roc(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> CurveOutput:
    """ROC curve ``(fpr, tpr, thresholds)``, binary or per class."""
    preds, target, num_classes, pos_label = _roc_update(preds, target, num_classes, pos_label)
    return _roc_compute(preds, target, num_classes, pos_label, sample_weights)
