"""IoU (Jaccard index) module metric.

Counterpart of ``metrics_tpu/classification/iou.py``: a ConfusionMatrix
subclass reducing diag/union at compute, so it shares one B2 launch per
batch with ``ConfusionMatrix``, ``CohenKappa`` and ``MatthewsCorrcoef`` in
a MetricCollection.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.functional.classification.iou import _iou_from_confmat
from metrics_tpu_torch.utilities.data import Tensor


class IoU(ConfusionMatrix):
    """Intersection over union accumulated over batches.

    Args:
        num_classes: number of classes.
        ignore_index: class dropped from the reduction (its row and column
            still count toward other classes' unions).
        absent_score: value reported for classes in neither preds nor target.
        threshold: probability cutoff binarizing float predictions.
        reduction: ``'elementwise_mean'`` | ``'sum'`` | ``'none'`` over the
            per-class IoU vector.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        absent_score: float = 0.0,
        threshold: float = 0.5,
        reduction: str = "elementwise_mean",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            normalize=None,
            threshold=threshold,
            multilabel=False,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.reduction = reduction
        self.ignore_index = ignore_index
        self.absent_score = absent_score

    def compute(self) -> Tensor:
        """IoU over everything seen so far."""
        return _iou_from_confmat(self.confmat, self.num_classes, self.ignore_index, self.absent_score, self.reduction)
