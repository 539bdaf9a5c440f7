"""ConfusionMatrix module metric.

Counterpart of ``metrics_tpu/classification/confusion_matrix.py``: one
fixed-shape sum-reduced ``confmat`` state (``(C, C)`` or ``(C, 2, 2)``).
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor


class _ConfmatUpdateMixin:
    """Shared-update protocol for metrics accumulating a confusion matrix.

    Metrics of this family with matching settings accumulate the identical
    batch matrix — one kernel pass serves them all in a MetricCollection. A
    subclass that overrides ``update`` opts out of sharing automatically.
    """

    @property
    def _confmat_multilabel(self) -> bool:
        return getattr(self, "multilabel", False)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the batch confusion matrix."""
        self._accumulate(*self._batch_deltas(preds, target))

    def _batch_deltas(self, preds: Tensor, target: Tensor) -> tuple:
        """This batch's confusion matrix — the shareable part of ``update``."""
        return (
            _confusion_matrix_update(
                preds, target, self.num_classes, self.threshold, self._confmat_multilabel
            ),
        )

    def _shared_update_key(self) -> Optional[tuple]:
        if type(self).update is not _ConfmatUpdateMixin.update:
            return None
        return ("confmat", self.num_classes, self.threshold, self._confmat_multilabel)

    def _accumulate(self, confmat: Tensor) -> None:
        self.confmat = self.confmat + confmat


class ConfusionMatrix(_ConfmatUpdateMixin, Metric):
    """Accumulated confusion matrix over batches.

    Args:
        num_classes: number of classes.
        normalize: ``None``/``'none'`` | ``'true'`` | ``'pred'`` | ``'all'``.
        threshold: probability threshold for binary/multilabel predictions.
        multilabel: compute a per-label ``(C, 2, 2)`` table instead.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
        threshold: float = 0.5,
        multilabel: bool = False,
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
        self.num_classes = num_classes
        self.normalize = normalize
        self.threshold = threshold
        self.multilabel = multilabel

        allowed_normalize = ("true", "pred", "all", "none", None)
        if normalize not in allowed_normalize:
            raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")

        default = torch.zeros((num_classes, 2, 2) if multilabel else (num_classes, num_classes), dtype=torch.int32)
        self.add_state("confmat", default=default, dist_reduce_fx="sum")

    def compute(self) -> Tensor:
        """Confusion matrix over everything seen so far."""
        return _confusion_matrix_compute(self.confmat, self.normalize)
