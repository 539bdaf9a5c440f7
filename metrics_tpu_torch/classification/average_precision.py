"""AveragePrecision module metric.

Counterpart of ``metrics_tpu/classification/average_precision.py``: list
mode (``"cat"`` states, exact step-function integral at compute),
``sketched=True`` (fixed label histograms filled by kernel B5, read by
:func:`~metrics_tpu_torch.kernels.sketches.hist_average_precision`) and
``capacity=N`` (a fixed-size sample buffer for the compiled step, the
masked sort-scan at compute; see :class:`~metrics_tpu_torch.AUROC`).
"""
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification.precision_recall_curve import _restore_curve_attributes
from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
)
from metrics_tpu_torch.functional.classification.masked_curves import masked_binary_average_precision
from metrics_tpu_torch.kernels.sketches import hist_average_precision
from metrics_tpu_torch.metric import Metric, StateDict
from metrics_tpu_torch.utilities.capped_buffer import CappedBufferMixin
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat
from metrics_tpu_torch.utilities.sketching import HistogramSketchMixin


class AveragePrecision(HistogramSketchMixin, CappedBufferMixin, Metric):
    """Average precision over all batches.

    Args:
        num_classes: class count for multi-class scores (per-class values);
            unset for binary streams.
        pos_label: which binary label counts as positive.
        capacity / overflow: the fixed-size sample buffer mode (see
            :class:`~metrics_tpu_torch.AUROC`); with ``num_classes > 1``
            compute returns the per-class values as a ``(C,)`` tensor.
        multilabel / sketched / num_bins / score_range: the sketched mode,
            as on :class:`~metrics_tpu_torch.AUROC`; multi-class sketched
            compute returns the per-class values as a ``(C,)`` tensor.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False
    _fusable = False
    _sketch_hint = (
        "Alternatively, AveragePrecision(sketched=True) keeps fixed-size"
        " binned-histogram states (bounded memory, one all_reduce at sync)."
    )

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
        if capacity is not None:
            self._init_capacity_states(capacity, num_classes, pos_label, multilabel=multilabel, overflow=overflow)
            return
        if multilabel:
            raise ValueError("`multilabel` is a `capacity`/`sketched`-mode hint; list mode infers it from data")
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append the canonicalized batch to the state (or bin it)."""
        if self.sketched:
            self._hist_update(preds, target)
            return
        if self.capacity is not None:
            self._buffer_update(preds, target)
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

        if self.capacity is not None:
            preds, target, valid = self._buffer_flatten()
            if self._capacity_multiclass or self._capacity_multilabel:
                # per-class/label values as a (C,) tensor (the list mode returns a list)
                return self._one_vs_rest(masked_binary_average_precision, preds, target, valid)
            return masked_binary_average_precision(preds, target, valid)

        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _average_precision_compute(preds, target, self.num_classes, self.pos_label)
