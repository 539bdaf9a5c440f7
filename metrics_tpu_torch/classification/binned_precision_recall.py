"""Binned (constant-memory, fixed-shape) precision-recall metrics.

Counterpart of ``metrics_tpu/classification/binned_precision_recall.py``:
fixed ``(C, T)`` ``"sum"`` count states, updated by one broadcast compare of
the scores against the ``T`` thresholds
(:func:`~metrics_tpu_torch.kernels.binned_counts.binned_tp_fp_fn`, plain
PyTorch as in the JAX package, where the compiler fuses it).
"""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute_with_precision_recall,
)
from metrics_tpu_torch.kernels.binned_counts import binned_tp_fp_fn
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import METRIC_EPS, Tensor, to_onehot


def _recall_at_precision(
    precision: Tensor, recall: Tensor, thresholds: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    """Lexicographic max of (recall, precision, threshold) where precision >= min."""
    num_t = thresholds.shape[0]
    p, r, t = precision[:num_t], recall[:num_t], thresholds
    valid = p >= min_precision

    max_recall = torch.max(torch.where(valid, r, -torch.inf))
    max_recall = torch.where(torch.isinf(max_recall), 0.0, max_recall).to(recall.dtype)

    tie = valid & (r == max_recall)
    p_masked = torch.where(tie, p, -torch.inf)
    tie = tie & (p_masked == torch.max(p_masked))
    best_threshold = torch.max(torch.where(tie, t, -torch.inf)).to(thresholds.dtype)

    best_threshold = torch.where(max_recall == 0.0, 1e6, best_threshold)
    return max_recall, best_threshold


class BinnedPrecisionRecallCurve(Metric):
    """Precision-recall pairs at ``num_thresholds`` evenly spaced thresholds.

    Constant-memory streaming alternative to :class:`PrecisionRecallCurve`:
    every state is a fixed-shape count tensor.

    Args:
        num_classes: number of classes (1 for binary).
        num_thresholds: number of evenly spaced thresholds in [0, 1].
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: int,
        num_thresholds: int = 100,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Any] = None,
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
        self.num_thresholds = num_thresholds
        # a state, so checkpoints carry it; identical on every process, so the
        # "max" sync changes nothing and keeps the fused forward available
        self.add_state(
            "thresholds",
            default=torch.linspace(0, 1.0, num_thresholds),
            dist_reduce_fx="max",
            persistent=True,
            buffer=True,
        )
        for name in ("TPs", "FPs", "FNs"):
            self.add_state(
                name,
                default=torch.zeros((num_classes, num_thresholds), dtype=torch.float32),
                dist_reduce_fx="sum",
            )

    def update(self, preds: Tensor, targets: Tensor) -> None:
        """Accumulate per-threshold tp/fp/fn counts for the batch."""
        preds, targets = torch.as_tensor(preds), torch.as_tensor(targets)
        if preds.ndim == targets.ndim == 1:  # binary
            preds = preds.reshape(-1, 1)
            targets = targets.reshape(-1, 1)

        if preds.ndim == targets.ndim + 1:
            targets = to_onehot(targets, num_classes=self.num_classes)

        tps, fps, fns = binned_tp_fp_fn(preds, targets, self.thresholds)
        self.TPs = self.TPs + tps
        self.FPs = self.FPs + fps
        self.FNs = self.FNs + fns

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        """Per-class (precision, recall, thresholds) with the (1, 0) endpoint."""
        precisions = (self.TPs + METRIC_EPS) / (self.TPs + self.FPs + METRIC_EPS)
        recalls = self.TPs / (self.TPs + self.FNs + METRIC_EPS)

        ones = torch.ones((self.num_classes, 1), dtype=precisions.dtype, device=precisions.device)
        precisions = torch.cat([precisions, ones], dim=1)
        recalls = torch.cat([recalls, torch.zeros_like(ones, dtype=recalls.dtype)], dim=1)
        if self.num_classes == 1:
            return precisions[0, :], recalls[0, :], self.thresholds
        return list(precisions), list(recalls), [self.thresholds for _ in range(self.num_classes)]


class BinnedAveragePrecision(BinnedPrecisionRecallCurve):
    """Average precision from the binned curve (constant memory).

    Args:
        num_classes: class/label count (1 = binary stream).
        num_thresholds: number of evenly spaced probability thresholds.
    """

    def compute(self) -> Union[List[Tensor], Tensor]:  # type: ignore[override]
        precisions, recalls, _ = super().compute()
        return _average_precision_compute_with_precision_recall(precisions, recalls, self.num_classes)


class BinnedRecallAtFixedPrecision(BinnedPrecisionRecallCurve):
    """Highest recall (and its threshold) with precision above a floor.

    Args:
        num_classes: class/label count (1 = binary stream).
        min_precision: the precision floor; recall 0 and threshold 1e6 for
            classes that never reach it.
        num_thresholds: number of evenly spaced probability thresholds.
    """

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        num_thresholds: int = 100,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Any] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            num_thresholds=num_thresholds,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        precisions, recalls, thresholds = super().compute()

        if self.num_classes == 1:
            return _recall_at_precision(precisions, recalls, thresholds, self.min_precision)

        recalls_at_p = []
        thresholds_at_p = []
        for i in range(self.num_classes):
            r, t = _recall_at_precision(precisions[i], recalls[i], thresholds[i], self.min_precision)
            recalls_at_p.append(r)
            thresholds_at_p.append(t)
        return torch.stack(recalls_at_p), torch.stack(thresholds_at_p)
