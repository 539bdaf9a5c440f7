"""AveragePrecision module metric.

Counterpart of ``metrics_tpu/classification/average_precision.py``: list
mode (``"cat"`` states, exact step-function integral at compute) and
``sketched=True`` (fixed label histograms filled by kernel B5, read by
:func:`~metrics_tpu_torch.kernels.sketches.hist_average_precision`). The
``capacity=`` mode is not ported yet and raises ``NotImplementedError``.
"""
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification.auroc import _refuse_capacity
from metrics_tpu_torch.classification.precision_recall_curve import _restore_curve_attributes
from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
)
from metrics_tpu_torch.kernels.sketches import hist_average_precision
from metrics_tpu_torch.metric import Metric, StateDict
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat
from metrics_tpu_torch.utilities.sketching import HistogramSketchMixin


class AveragePrecision(HistogramSketchMixin, Metric):
    """Average precision over all batches.

    Args:
        num_classes: class count for multi-class scores (per-class values);
            unset for binary streams.
        pos_label: which binary label counts as positive.
        capacity / overflow: the JAX package's fixed-buffer mode, not ported
            yet (raises ``NotImplementedError``).
        multilabel / sketched / num_bins / score_range: the sketched mode,
            as on :class:`~metrics_tpu_torch.AUROC`; multi-class sketched
            compute returns the per-class values as a ``(C,)`` tensor.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False
    _fusable = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        capacity: Optional[int] = None,
        multilabel: bool = False,
        sketched: bool = False,
        num_bins: int = 2048,
        score_range: Tuple[float, float] = (0.0, 1.0),
        overflow: str = "warn",
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
        self.capacity = capacity
        self.sketched = sketched

        if sketched:
            if capacity is not None:
                raise ValueError("`sketched` and `capacity` modes are mutually exclusive")
            self._fusable = True
            self._init_hist_states(num_bins, score_range, num_classes, pos_label, multilabel=multilabel)
            return
        _refuse_capacity(capacity, overflow)
        if multilabel:
            raise ValueError("`multilabel` is a `capacity`/`sketched`-mode hint; list mode infers it from data")
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append the canonicalized batch to the state (or bin it)."""
        if self.sketched:
            self._hist_update(preds, target)
            return

        preds, target, num_classes, pos_label = _average_precision_update(
            preds, target, self.num_classes, self.pos_label
        )
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def _restore_derived(self, state: StateDict) -> None:
        _restore_curve_attributes(self, state)

    def compute(self) -> Union[List[Tensor], Tensor]:
        """Average precision over everything seen so far."""
        if self.sketched:
            # per-class/label APs as a (C,) tensor (binary: the scalar); a
            # degenerate stream gives NaN, as the exact recall does, no raise
            per_class = hist_average_precision(self.pos_hist, self.neg_hist)
            self._publish_hist_info()
            if self._sketch_multiclass or self._sketch_multilabel:
                return per_class
            return per_class[0]

        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _average_precision_compute(preds, target, self.num_classes, self.pos_label)
