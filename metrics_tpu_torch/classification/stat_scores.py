"""StatScores module metric — the stateful tp/fp/tn/fn accumulator.

Counterpart of ``metrics_tpu/classification/stat_scores.py``: fixed-shape
sum-reduced states for global counting (micro scalar / macro ``(C,)``), or
list ("cat") states for samplewise counting. Base class of Accuracy /
Precision / Recall / FBeta / F1.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_compute, _stat_scores_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.checks import _check_classification_inputs, _input_squeeze
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod


class StatScores(Metric):
    """Computes the number of true/false positives and true/false negatives.

    Args:
        threshold: probability threshold binarizing prob/logit predictions.
        top_k: number of highest-probability predictions considered correct
            for (multi-dim) multi-class inputs.
        reduce: counting granularity — ``'micro'`` (global), ``'macro'``
            (per class; requires ``num_classes``), ``'samples'`` (per sample).
        num_classes: number of classes (required for macro counting).
        ignore_index: class index excluded from the counts (macro: its stats
            are reported as ``-1``).
        mdmc_reduce: ``'global'`` or ``'samplewise'`` handling of the extra
            dims of multi-dim multi-class inputs.
        multiclass: override the inferred input case.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        reduce: str = "micro",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        mdmc_reduce: Optional[str] = None,
        multiclass: Optional[bool] = None,
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

        self.reduce = reduce
        self.mdmc_reduce = mdmc_reduce
        self.num_classes = num_classes
        self.threshold = threshold
        self.multiclass = multiclass
        self.ignore_index = ignore_index
        self.top_k = top_k

        if not 0 < threshold < 1:
            raise ValueError(f"The `threshold` should be a float in the (0,1) interval, got {threshold}")

        if reduce not in ["micro", "macro", "samples"]:
            raise ValueError(f"The `reduce` {reduce} is not valid.")

        if mdmc_reduce not in [None, "samplewise", "global"]:
            raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")

        if reduce == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")

        if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

        if mdmc_reduce != "samplewise" and reduce != "samples":
            zeros_shape = () if reduce == "micro" else (num_classes,)
            default, reduce_fn = lambda: torch.zeros(zeros_shape, dtype=torch.int32), "sum"
        else:
            default, reduce_fn = lambda: [], None

        for s in ("tp", "fp", "tn", "fn"):
            self.add_state(s, default=default(), dist_reduce_fx=reduce_fn)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate tp/fp/tn/fn from a batch of predictions and targets."""
        self._accumulate(*self._batch_deltas(preds, target))

    def _batch_deltas(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """This batch's (tp, fp, tn, fn) — the shareable part of ``update``."""
        return _stat_scores_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            multiclass=self.multiclass,
            ignore_index=self.ignore_index,
        )

    def _validate_batch(self, preds: Tensor, target: Tensor) -> None:
        """The value checks of the canonicalization, on the whole batch."""
        preds, target = _input_squeeze(torch.as_tensor(preds), torch.as_tensor(target))
        if preds.dtype in (torch.float16, torch.bfloat16):
            preds = preds.float()
        _check_classification_inputs(preds, target, self.threshold, self.num_classes, self.multiclass, self.top_k)

    def _shared_update_key(self) -> Optional[Tuple]:
        # sharing is only valid when the subclass runs StatScores' update
        # verbatim (Accuracy overrides it with extra states)
        if type(self).update is not StatScores.update:
            return None
        return (
            "stat_scores",
            self.reduce,
            self.mdmc_reduce,
            self.threshold,
            self.num_classes,
            self.top_k,
            self.multiclass,
            self.ignore_index,
        )

    def _accumulate(self, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> None:
        """Add fixed-shape counts, or append samplewise counts."""
        if self.mdmc_reduce == "samplewise" and self.reduce == "micro" and tp.ndim == 0:
            # 0-dim per-batch stats cannot be accumulated samplewise (their
            # concatenation at compute() fails) while the functional path
            # works — so the guard lives here, not in the functional code
            raise ValueError(
                "`mdmc_reduce='samplewise'` with `reduce='micro'` requires multi-dimensional multi-class inputs"
            )
        if self.reduce != AverageMethod.SAMPLES and self.mdmc_reduce != MDMCAverageMethod.SAMPLEWISE:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn
        else:
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)

    def _get_final_stats(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """Concatenate samplewise list states (no-op for fixed-shape states)."""
        if isinstance(self.tp, list):
            return (
                dim_zero_cat(self.tp),
                dim_zero_cat(self.fp),
                dim_zero_cat(self.tn),
                dim_zero_cat(self.fn),
            )
        return self.tp, self.fp, self.tn, self.fn

    def compute(self) -> Tensor:
        """``[..., (tp, fp, tn, fn, support)]`` over everything seen so far."""
        tp, fp, tn, fn = self._get_final_stats()
        return _stat_scores_compute(tp, fp, tn, fn)
