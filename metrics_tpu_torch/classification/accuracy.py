"""Accuracy module metric.

Counterpart of ``metrics_tpu/classification/accuracy.py``: a StatScores
subclass with extra sum-reduced ``correct``/``total`` states for the
subset-accuracy path and mode-locking across updates.
"""
from typing import Any, Callable, Dict, Optional, Union

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.accuracy import (
    _accuracy_compute,
    _accuracy_update,
    _check_subset_validity,
    _mode,
    _subset_accuracy_compute,
    _subset_accuracy_update,
)
from metrics_tpu_torch.utilities.data import Tensor, _is_batched
from metrics_tpu_torch.utilities.enums import DataType

#: mode <-> synced-code mapping for the ``mode_code`` state (0 = unset; the
#: order is arbitrary but frozen — the max-reduction just needs "any seen
#: mode beats unset")
_MODE_CODES = (
    None,
    DataType.BINARY,
    DataType.MULTILABEL,
    DataType.MULTICLASS,
    DataType.MULTIDIM_MULTICLASS,
)


class Accuracy(StatScores):
    """Fraction of correctly classified samples.

    Works on every classification input case (binary / multi-class /
    multi-label / multi-dim multi-class, probabilities or labels); ``top_k``
    generalizes to top-K accuracy; ``subset_accuracy`` requires whole samples
    to match for multi-label / multi-dim inputs.

    Args:
        threshold: probability cutoff that binarizes float predictions in the
            binary/multi-label cases.
        num_classes: class count. Optional (inferred from the data when not given).
        average: how per-class results combine — ``"micro"`` pools all
            decisions, ``"macro"`` averages classes equally, ``"weighted"``
            weights classes by support, ``"samples"`` averages per-sample
            scores, ``"none"``/``None`` returns the per-class vector.
        mdmc_average: how the extra dimension of multi-dim multi-class
            inputs is handled: ``"global"`` flattens it into the sample axis,
            ``"samplewise"`` computes per-sample then averages.
        ignore_index: class label excluded from the score (its column is
            dropped, or masked when it is the only class).
        top_k: count a sample correct when the true class is within the
            ``k`` highest-probability predictions (prob-like multi-class /
            multi-dim inputs only).
        multiclass: force inputs to be treated as multi-class (``True``) or
            binary/multi-label (``False``) when the automatic case inference
            would decide otherwise.
        subset_accuracy: for multi-label / multi-dim inputs, require EVERY
            label of a sample to match for the sample to count.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False

    def __init__(
        self,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        average: str = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        subset_accuracy: bool = False,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        allowed_average = ["micro", "macro", "weighted", "samples", "none", None]
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

        super().__init__(
            reduce="macro" if average in ["weighted", "none", None] else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )

        self.add_state("correct", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        # The data mode steers compute()'s formula (binary/multilabel micro is
        # (tp+tn)/all, multiclass is tp/(tp+fn)) but is only learned at
        # update() — a rank that never updated would silently take the wrong
        # branch on the SYNCED global counts and disagree with its peers. A
        # max-reduced code state makes the mode travel with the sync
        # (non-persistent: checkpoints keep the JAX package's keys).
        self.add_state("mode_code", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="max")

        if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
            raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

        self.average = average
        self.threshold = threshold
        self.top_k = top_k
        self.subset_accuracy = subset_accuracy
        self.mode = None
        self.multiclass = multiclass

    def persistent(self, mode: bool = False) -> None:
        """Flip state persistence (same default as :meth:`Metric.persistent`);
        ``mode_code`` stays out of checkpoints (sync bookkeeping, not a
        reference state — key parity)."""
        super().persistent(mode)
        self._persistent["mode_code"] = False

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate accuracy statistics from a batch."""
        mode = _mode(preds, target, self.threshold, self.top_k, self.num_classes, self.multiclass)

        if self.mode is None:
            self.mode = mode
        elif self.mode != mode:
            raise ValueError(f"You can not use {mode} inputs with {self.mode} inputs.")
        self.mode_code = torch.clamp(self.mode_code, min=_MODE_CODES.index(mode))

        if self.subset_accuracy and not _check_subset_validity(self.mode):
            self.subset_accuracy = False

        if self.subset_accuracy:
            correct, total = _subset_accuracy_update(preds, target, threshold=self.threshold, top_k=self.top_k)
            self.correct = self.correct + correct
            self.total = self.total + total
        else:
            tp, fp, tn, fn = _accuracy_update(
                preds,
                target,
                reduce=self.reduce,
                mdmc_reduce=self.mdmc_reduce,
                threshold=self.threshold,
                num_classes=self.num_classes,
                top_k=self.top_k,
                multiclass=self.multiclass,
                ignore_index=self.ignore_index,
                mode=self.mode,
            )

            self._accumulate(tp, fp, tn, fn)

    def _restore_derived(self, state: Dict[str, Tensor]) -> None:
        """Decode the learned data mode from installed ``mode_code`` states
        (a fresh instance never saw a batch). The max over the possibly
        tenant-stacked codes mirrors the ``dist_reduce_fx="max"`` sync; it is
        read once, on the host, before a keyed compute fans out per tenant."""
        if self.mode is not None or "mode_code" not in state:
            return
        code = int(torch.as_tensor(state["mode_code"]).max())
        if code:
            self.mode = _MODE_CODES[code]

    def _effective_mode(self):
        """The data mode for compute(): locally learned, or — when this process
        never updated, or its states were installed from elsewhere — decoded
        from the (synced) ``mode_code``. Inside a vmapped compute no value can
        be read: the mode is then what update or :meth:`_restore_derived` set."""
        if self.mode is not None or _is_batched(self.mode_code):
            return self.mode
        return _MODE_CODES[int(self.mode_code.max().item())]

    def compute(self) -> Tensor:
        """Accuracy over everything seen so far."""
        if self.subset_accuracy:
            return _subset_accuracy_compute(self.correct, self.total)
        tp, fp, tn, fn = self._get_final_stats()
        return _accuracy_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce, self._effective_mode())
