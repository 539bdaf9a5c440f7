"""Intersection over union (Jaccard index).

Counterpart of ``metrics_tpu/functional/classification/iou.py``: diag/union
of the confusion matrix (kernel B2), ``absent_score`` for classes in neither
preds nor target, and ``ignore_index`` sliced out before the reduction.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.utilities.data import Tensor, get_num_classes
from metrics_tpu_torch.utilities.distributed import reduce


def _iou_from_confmat(
    confmat: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> Tensor:
    intersection = torch.diag(confmat)
    union = torch.sum(confmat, dim=0) + torch.sum(confmat, dim=1) - intersection

    scores = intersection.float() / torch.where(union == 0, 1, union).float()
    scores = torch.where(union == 0, absent_score, scores)

    if ignore_index is not None and 0 <= ignore_index < num_classes:
        scores = torch.cat([scores[:ignore_index], scores[ignore_index + 1 :]])
    return reduce(scores, reduction=reduction)


def iou(
    preds: Tensor,
    target: Tensor,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Jaccard index ``|A ∩ B| / |A ∪ B|`` over class masks."""
    num_classes = get_num_classes(preds=preds, target=target, num_classes=num_classes)
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold)
    return _iou_from_confmat(confmat, num_classes, ignore_index, absent_score, reduction)
