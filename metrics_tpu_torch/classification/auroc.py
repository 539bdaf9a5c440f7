"""AUROC module metric.

Counterpart of ``metrics_tpu/classification/auroc.py``, in two modes:

* list mode (the default): ``"cat"`` list states of the canonicalized
  scores and targets, with the data mode (binary, multiclass, multilabel)
  locked at the first update and the exact sort-scan at compute;
* ``sketched=True``: fixed ``(C, num_bins)`` label histograms
  (:class:`~metrics_tpu_torch.utilities.sketching.HistogramSketchMixin`),
  filled on the card by kernel B5 and read by
  :func:`~metrics_tpu_torch.kernels.sketches.hist_auroc`;
* ``capacity=N``: a fixed-size sample buffer and a fill counter
  (:class:`~metrics_tpu_torch.utilities.capped_buffer.CappedBufferMixin`),
  whose state keeps its shape, so the compiled step captures it once; the
  masked sort-scan of
  :mod:`~metrics_tpu_torch.functional.classification.masked_curves` at
  compute. Binary by default, multiclass with ``num_classes=C``
  (one-vs-rest), multilabel with ``multilabel=True``; samples past the
  capacity drop with a warning, or raise at ``compute()`` with
  ``overflow="error"``.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.auroc import _auroc_compute, _auroc_update
from metrics_tpu_torch.functional.classification.masked_curves import masked_binary_auroc
from metrics_tpu_torch.kernels.sketches import hist_auroc
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.capped_buffer import CappedBufferMixin
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat
from metrics_tpu_torch.utilities.sketching import HistogramSketchMixin


class AUROC(HistogramSketchMixin, CappedBufferMixin, Metric):
    """Area under the ROC curve over all batches.

    Args:
        num_classes: class count for multi-class scores (one-vs-rest at
            compute); leave unset for binary streams.
        pos_label: which of the two binary labels counts as positive.
        average: ``"macro"``, ``"weighted"``, ``"micro"`` (multilabel list
            mode) or ``None`` (per class).
        max_fpr: integrate only up to this false-positive rate and
            standardize (McClish correction); binary list mode only.
        capacity: accumulate into a fixed-size sample buffer instead of the
            unbounded lists (a state of fixed shape, for the compiled step).
            Binary by default; with ``num_classes > 1`` the one-vs-rest
            macro/weighted average. Incompatible with ``max_fpr``.
        overflow: capacity-mode policy past the buffer: ``"warn"`` (drop and
            warn) or ``"error"`` (raise
            :class:`~metrics_tpu_torch.utilities.capped_buffer.BufferOverflowError`
            at the next eager ``compute()``).
        multilabel: capacity/sketched-mode hint that ``(N, C)`` inputs are
            per-label binaries rather than class probabilities.
        sketched: keep two fixed ``(C, num_bins)`` histograms instead of the
            O(samples) lists; the value matches the exact one within the
            JAX package's documented tolerance (each bin acts as one tie
            group).
        num_bins: sketched-mode histogram resolution (default 2048).
        score_range: sketched-mode score grid bounds (default ``(0, 1)``);
            out-of-range scores clip into the edge bins and are counted in
            ``sketch_clipped``.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False
    _fusable = False
    _sketch_hint = (
        "Alternatively, AUROC(sketched=True) keeps fixed-size binned-histogram"
        " states (bounded memory, one all_reduce at sync regardless of sample count)."
    )

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
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
        self.average = average
        self.max_fpr = max_fpr
        self.capacity = capacity
        self.sketched = sketched
        self.mode = None

        allowed_average = (None, "macro", "weighted", "micro")
        if average not in allowed_average:
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )

        if max_fpr is not None and (not isinstance(max_fpr, float) or not 0 < max_fpr <= 1):
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")

        if sketched:
            if capacity is not None:
                raise ValueError("`sketched` and `capacity` modes are mutually exclusive")
            if max_fpr is not None:
                raise ValueError("`sketched` mode does not support `max_fpr`")
            if num_classes is not None and num_classes > 1 and average not in (None, "macro", "weighted"):
                raise ValueError("multi-class `sketched` mode supports average None, 'macro' or 'weighted'")
            # histogram states are plain "sum" tensors: the fused forward applies
            self._fusable = True
            self._init_hist_states(num_bins, score_range, num_classes, pos_label, multilabel=multilabel)
            return
        if capacity is not None:
            if max_fpr is not None:
                raise ValueError("`capacity` mode does not support `max_fpr`")
            if num_classes is not None and num_classes > 1 and average not in ("macro", "weighted"):
                raise ValueError("multi-column `capacity` mode supports average 'macro' or 'weighted'")
            self._init_capacity_states(capacity, num_classes, pos_label, multilabel=multilabel, overflow=overflow)
            return
        if multilabel:
            raise ValueError("`multilabel` is a `capacity`/`sketched`-mode hint; list mode infers it from data")
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append the batch scores/targets to the state (or bin them)."""
        if self.sketched:
            self._hist_update(preds, target)
            return
        if self.capacity is not None:
            self._buffer_update(preds, target)
            return

        preds, target, mode = _auroc_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

        if self.mode is not None and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def compute(self) -> Tensor:
        """AUROC over everything seen so far."""
        if self.sketched:
            supports = self._hist_check_degenerate()
            per_class = hist_auroc(self.pos_hist, self.neg_hist)
            self._publish_hist_info()
            if self._sketch_multiclass or self._sketch_multilabel:
                if self.average == "weighted":
                    support = supports if supports is not None else torch.sum(self.pos_hist, dim=-1)
                    return torch.sum(per_class * support / torch.clamp(torch.sum(support), min=1.0))
                if self.average is None:
                    return per_class
                return torch.mean(per_class)
            return per_class[0]

        if self.capacity is not None:
            preds, target, valid = self._buffer_flatten()
            supports = self._check_degenerate_classes(target, valid)
            if self._capacity_multiclass or self._capacity_multilabel:
                per_class = self._one_vs_rest(masked_binary_auroc, preds, target, valid)
                if self.average == "weighted":
                    support = supports if supports is not None else self._class_supports(target, valid)
                    return torch.sum(per_class * support / torch.clamp(torch.sum(support), min=1.0))
                return torch.mean(per_class)
            return masked_binary_auroc(preds, target, valid)

        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        mode = self.mode
        if mode is None and preds.numel() > 0:
            # this process never updated (or its states were loaded) but holds
            # a stream: infer the data mode from it, as update() would have
            _, _, mode = _auroc_update(preds, target)
        return _auroc_compute(
            preds,
            target,
            mode,
            num_classes=self.num_classes,
            pos_label=self.pos_label,
            average=self.average,
            max_fpr=self.max_fpr,
        )
