"""PrecisionRecallCurve module metric.

Counterpart of ``metrics_tpu/classification/precision_recall_curve.py``:
list mode (unbounded ``"cat"`` states, the exact curve at epoch end) and
``sketched=True`` (fixed label histograms filled by kernel B5; the curve at
the ascending bin edges, in the ``BinnedPrecisionRecallCurve`` output
convention).
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    CurveOutput,
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.kernels.sketches import hist_precision_recall_curve
from metrics_tpu_torch.metric import Metric, StateDict
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat
from metrics_tpu_torch.utilities.sketching import HistogramSketchMixin


def _restore_curve_attributes(metric: Metric, state: StateDict) -> None:
    """``num_classes``/``pos_label`` of a list-mode curve metric whose states
    were installed without an update, as its updates would have set them:
    equal-rank scores and targets are binary (or multilabel) with
    ``pos_label`` 1, an extra score axis holds the classes."""
    preds, target = state.get("preds"), state.get("target")
    if metric.sketched or not preds:
        return
    if preds[0].ndim == target[0].ndim:
        metric.pos_label = 1 if metric.pos_label is None else metric.pos_label
        if preds[0].ndim == 1:
            metric.num_classes = 1
    if metric.num_classes is None:
        metric.num_classes = preds[0].shape[1]


class PrecisionRecallCurve(HistogramSketchMixin, Metric):
    """Precision/recall pairs at every distinct threshold, over all batches.

    Args:
        num_classes: class count for multi-class scores (returns per-class
            curve lists); unset for binary streams.
        pos_label: which binary label counts as positive.
        sketched / num_bins / score_range / multilabel: the sketched mode, as
            on :class:`~metrics_tpu_torch.AUROC`: ``num_bins + 1`` precision
            and recall values over the ``num_bins`` ascending bin edges.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False
    _fusable = False  # list-mode forward values are tuples or lists, not mergeable tensors

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        sketched: bool = False,
        num_bins: int = 2048,
        score_range: Tuple[float, float] = (0.0, 1.0),
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
        self.pos_label = pos_label
        self.sketched = sketched

        if sketched:
            self._fusable = True
            self._init_hist_states(num_bins, score_range, num_classes, pos_label, multilabel=multilabel)
            return
        if multilabel:
            raise ValueError("`multilabel` is a `sketched`-mode hint; list mode infers it from data")
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append the canonicalized batch to the curve state (or bin it)."""
        if self.sketched:
            self._hist_update(preds, target)
            return
        preds, target, num_classes, pos_label = _precision_recall_curve_update(
            preds, target, self.num_classes, self.pos_label
        )
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def _restore_derived(self, state: StateDict) -> None:
        _restore_curve_attributes(self, state)

    def compute(self) -> CurveOutput:
        """(precision, recall, thresholds) over everything seen so far."""
        if self.sketched:
            lo, hi = self._sketch_range
            precision, recall, thresholds = hist_precision_recall_curve(self.pos_hist, self.neg_hist, lo, hi)
            self._publish_hist_info()
            if self._sketch_multiclass or self._sketch_multilabel:
                return list(precision), list(recall), [thresholds for _ in range(self.num_classes)]
            return precision[0], recall[0], thresholds
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _precision_recall_curve_compute(preds, target, self.num_classes, self.pos_label)
