"""Hinge module metric.

Counterpart of ``metrics_tpu/classification/hinge.py``: sum-reduced
``measure`` (float32; a ``(C,)`` vector once a one-vs-all batch lands) and
``total`` states.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.hinge import MulticlassMode, _hinge_compute, _hinge_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor


class Hinge(Metric):
    """Mean hinge loss accumulated over batches.

    Args:
        squared: square each sample's hinge loss before averaging.
        multiclass_mode: ``None`` — Crammer-Singer margin (true-class score
            minus the best other class); ``'one-vs-all'`` — a ``(C,)`` vector
            of per-class binary hinge losses.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = True

    def __init__(
        self,
        squared: bool = False,
        multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
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
        self.add_state("measure", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

        if multiclass_mode not in (None, MulticlassMode.CRAMMER_SINGER, MulticlassMode.ONE_VS_ALL):
            raise ValueError(
                "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
                "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
                f" got {multiclass_mode}."
            )
        self.squared = squared
        self.multiclass_mode = multiclass_mode

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the batch hinge measure."""
        measure, total = _hinge_update(preds, target, squared=self.squared, multiclass_mode=self.multiclass_mode)
        self.measure = measure + self.measure
        self.total = total + self.total

    def compute(self) -> Tensor:
        """Hinge loss over everything seen so far."""
        return _hinge_compute(self.measure, self.total)
