"""ROC module metric.

Counterpart of ``metrics_tpu/classification/roc.py``: list mode (the exact
curve at epoch end) and ``sketched=True`` (fixed label histograms filled by
kernel B5; the curve at the ``num_bins + 1`` grid points, starting from
(0, 0) at threshold ``hi``).
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification.precision_recall_curve import _restore_curve_attributes
from metrics_tpu_torch.functional.classification.precision_recall_curve import CurveOutput
from metrics_tpu_torch.functional.classification.roc import _roc_compute, _roc_update
from metrics_tpu_torch.kernels.sketches import hist_roc
from metrics_tpu_torch.metric import Metric, StateDict
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat
from metrics_tpu_torch.utilities.sketching import HistogramSketchMixin


class ROC(HistogramSketchMixin, Metric):
    """ROC curve (fpr, tpr, thresholds) over all batches.

    Args:
        num_classes: class count for multi-class scores (returns per-class
            curve lists); unset for binary streams.
        pos_label: which binary label counts as positive.
        sketched / num_bins / score_range / multilabel: the sketched mode, as
            on :class:`~metrics_tpu_torch.AUROC`.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False
    _fusable = False

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
        preds, target, num_classes, pos_label = _roc_update(preds, target, self.num_classes, self.pos_label)
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def _restore_derived(self, state: StateDict) -> None:
        _restore_curve_attributes(self, state)

    def compute(self) -> CurveOutput:
        """(fpr, tpr, thresholds) over everything seen so far."""
        if self.sketched:
            lo, hi = self._sketch_range
            fpr, tpr, thresholds = hist_roc(self.pos_hist, self.neg_hist, lo, hi)
            self._publish_hist_info()
            if self._sketch_multiclass or self._sketch_multilabel:
                return list(fpr), list(tpr), [thresholds for _ in range(self.num_classes)]
            return fpr[0], tpr[0], thresholds
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _roc_compute(preds, target, self.num_classes, self.pos_label)
