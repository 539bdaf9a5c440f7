"""Precision-recall curve and the shared binary sort-scan.

Counterpart of ``metrics_tpu/functional/classification/precision_recall_curve.py``
(``_binary_clf_curve`` at ``:25-63``, the update reshapes at ``:66-109``,
the curve compute at ``:112-148``). Curve lengths depend on the data (one
point per distinct threshold), so these run eagerly at epoch end: one
stable sort and cumulative sums on the device, then the distinct-threshold
compaction. The sketched curve metrics keep fixed shapes instead.

Sort order: the JAX package sorts the key ``(-preds, index)`` ascending,
which puts NaN scores last and breaks ties by index; ``torch.sort`` of
``-preds`` with ``stable=True`` gives the same order (``descending=True``
would put NaN first). Counts are float32 (``target * 1.0``), the dtype the
JAX package gives without x64.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.utilities.data import Tensor, to_host
from metrics_tpu_torch.utilities.prints import rank_zero_warn

CurveOutput = Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]


def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Cumulative fps/tps per distinct decreasing threshold (sklearn-style)."""
    if sample_weights is not None and not isinstance(sample_weights, Tensor):
        sample_weights = torch.as_tensor(sample_weights, dtype=torch.float32, device=preds.device)

    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    keys, order = torch.sort(-preds, stable=True)
    preds = -keys  # exact inverse of the key negation
    target = target[order]
    weight = sample_weights[order] if sample_weights is not None else 1.0

    distinct_value_indices = torch.nonzero(preds[1:] - preds[:-1]).reshape(-1)
    last = torch.tensor([target.shape[0] - 1], device=preds.device)
    threshold_idxs = torch.cat([distinct_value_indices, last])

    target = (target == pos_label).to(torch.int64 if target.dtype == torch.int64 else torch.int32)
    tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]

    if sample_weights is not None:
        fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    else:
        fps = 1 + threshold_idxs - tps

    return fps, tps, preds[threshold_idxs]


def _precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[Tensor, Tensor, int, int]:
    """Reshape binary/multilabel/multiclass inputs to the curve layout."""
    if not (preds.ndim == target.ndim or preds.ndim == target.ndim + 1):
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")

    if preds.ndim == target.ndim:
        if pos_label is None:
            rank_zero_warn("`pos_label` automatically set 1.")
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            # multilabel: (N, C, ...) -> (N * X, C)
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} in"
                    f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                    " number of classes from predictions"
                )
            preds = torch.swapaxes(preds, 0, 1).reshape(num_classes, -1).T
            target = torch.swapaxes(target, 0, 1).reshape(num_classes, -1).T
        else:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1

    if preds.ndim == target.ndim + 1:
        if pos_label is not None:
            rank_zero_warn(
                f"Argument `pos_label` should be `None` when running multiclass precision recall curve. Got {pos_label}"
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} in"
                f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                " number of classes from predictions"
            )
        preds = torch.swapaxes(preds, 0, 1).reshape(num_classes, -1).T
        target = target.reshape(-1)

    return preds, target, num_classes, pos_label


def _precision_recall_curve_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> CurveOutput:
    if num_classes == 1:
        fps, tps, thresholds = _binary_clf_curve(
            preds=preds, target=target, sample_weights=sample_weights, pos_label=pos_label
        )

        precision = tps / (tps + fps)
        recall = tps / tps[-1]

        # stop once full recall is attained, reverse so recall decreases,
        # and append the (1, 0) endpoint
        last_ind = int(to_host(torch.nonzero(tps == tps[-1])[0, 0]))
        sl = slice(0, last_ind + 1)

        one = torch.ones(1, dtype=precision.dtype, device=precision.device)
        precision = torch.cat([torch.flip(precision[sl], (0,)), one])
        recall = torch.cat([torch.flip(recall[sl], (0,)), torch.zeros_like(one, dtype=recall.dtype)])
        thresholds = torch.flip(thresholds[sl], (0,))

        return precision, recall, thresholds

    # per-class recursion on the class columns
    precision, recall, thresholds = [], [], []
    for c in range(num_classes):
        res = precision_recall_curve(
            preds=preds[:, c], target=target, num_classes=1, pos_label=c, sample_weights=sample_weights
        )
        precision.append(res[0])
        recall.append(res[1])
        thresholds.append(res[2])

    return precision, recall, thresholds


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> CurveOutput:
    """Precision/recall pairs at every distinct decision threshold: binary
    tensors, or per-class lists for multiclass scores."""
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)
