"""StatScores module metric — the stateful tp/fp/tn/fn accumulator.

Counterpart of ``metrics_tpu/classification/stat_scores.py``: fixed-shape
sum-reduced states for global counting (micro scalar / macro ``(C,)``), or
list ("cat") states for samplewise counting. Base class of Accuracy /
Precision / Recall / FBeta / F1.
"""
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.stat_scores import (
    _stat_scores_compute,
    _stat_scores_count,
    _stat_scores_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.checks import (
    _check_classification_inputs,
    _input_format_classification,
    _input_squeeze,
    _rows_format_alike,
)
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat
from metrics_tpu_torch.utilities.enums import AverageMethod, DataType, MDMCAverageMethod
from metrics_tpu_torch.utilities.profiling import compiled_scope

_COUNTS = ("tp", "fp", "tn", "fn")


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

    def _row_states(self, *args: Any, **kwargs: Any) -> Optional[Dict[str, Tensor]]:
        """The batched-rows form (:meth:`Metric._row_states`) of
        ``StatScores.update``: the batch canonicalized once without reading a
        value, then each row's counts, micro ones summed a row, macro ones
        from B1's batched entry over the ``(B, 1, C)`` stack."""
        batch = self._rows_batch(args, kwargs)
        if batch is None or type(self).update is not StatScores.update:
            return None
        return self._rows_counts(*batch)[0]

    def _rows_batch(self, args: Tuple, kwargs: Dict[str, Any]) -> Optional[Tuple[Tensor, Tensor]]:
        """``(preds, target)`` of an update's arguments where the batched-rows
        form holds: fixed-shape states (``reduce`` micro or macro, no
        samplewise ``mdmc_reduce``) and a batch that canonicalizes row by row
        as each row alone does (:func:`_rows_format_alike`); else ``None``."""
        if self.reduce == AverageMethod.SAMPLES or self.mdmc_reduce == MDMCAverageMethod.SAMPLEWISE:
            return None
        bound = dict(zip(("preds", "target"), args), **kwargs)
        if len(args) + len(kwargs) != 2 or set(bound) != {"preds", "target"}:
            return None
        preds, target = bound["preds"], bound["target"]
        if not _rows_format_alike(preds, target, self.num_classes, self.multiclass):
            return None
        return preds, target

    def _rows_counts(self, preds: Tensor, target: Tensor) -> Tuple[Dict[str, Tensor], DataType]:
        """Each row's ``tp``/``fp``/``tn``/``fn`` of a batch that
        :meth:`_rows_batch` admitted, and the batch's case: the batch
        canonicalized once as ``update`` canonicalizes it, with no value read,
        then counted a row."""
        with compiled_scope(f"{type(self).__name__}.update"):
            preds, target, case = _input_format_classification(
                preds, target, threshold=self.threshold, top_k=self.top_k, num_classes=self.num_classes,
                multiclass=self.multiclass, read_values=False,
            )
            counts = _stat_scores_count(preds, target, self.reduce, self.mdmc_reduce, self.ignore_index, rows=True)
        return dict(zip(_COUNTS, counts)), case

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
