"""CohenKappa module metric.

Counterpart of ``metrics_tpu/classification/cohen_kappa.py``: the
confusion-matrix state and update (``_ConfmatUpdateMixin``, kernel B2).
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.classification.confusion_matrix import _ConfmatUpdateMixin
from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_compute
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor


class CohenKappa(_ConfmatUpdateMixin, Metric):
    """Cohen's kappa agreement score accumulated over batches.

    Args:
        num_classes: number of classes.
        weights: disagreement weighting: ``None`` (plain agreement),
            ``'linear'`` or ``'quadratic'`` distance weighting.
        threshold: probability cutoff binarizing float predictions.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: int,
        weights: Optional[str] = None,
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
        self.num_classes = num_classes
        self.weights = weights
        self.threshold = threshold

        allowed_weights = ("linear", "quadratic", "none", None)
        if weights not in allowed_weights:
            raise ValueError(f"Argument weights needs to one of the following: {allowed_weights}")

        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def compute(self) -> Tensor:
        """Cohen's kappa over everything seen so far."""
        return _cohen_kappa_compute(self.confmat, None if self.weights == "none" else self.weights)
