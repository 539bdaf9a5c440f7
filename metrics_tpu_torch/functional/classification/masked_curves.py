"""Fixed-shape (masked) binary curve scalars — AUROC and average precision.

Counterpart of ``metrics_tpu/functional/classification/masked_curves.py``,
as plain PyTorch. The list-mode curves trim to distinct thresholds, a shape
that depends on the data; the curve *scalars* need no such trim: every
sorted sample stays a curve point, each point carries the cumulative counts
at the end of its prediction tie group (so tied points duplicate the group's
last point), and duplicates add zero-width trapezoids or zero-Δrecall terms.
Invalid (padding) entries sort last with ``-inf`` scores and zero weight.
No value is read to the host, so the functions run inside a compiled step.

This backs the ``capacity=`` mode of :class:`~metrics_tpu_torch.AUROC` and
:class:`~metrics_tpu_torch.AveragePrecision`. Every function takes ``(N,)``
inputs (one curve, a 0-d result) or ``(N, C)`` scores and binary targets
with an ``(N,)`` mask (one curve per column, a ``(C,)`` result).
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.data import METRIC_EPS, Tensor


def _reverse_cummin(x: Tensor) -> Tensor:
    """The smallest value at or after each position along dim 0."""
    return torch.flip(torch.cummin(torch.flip(x, dims=(0,)), dim=0).values, dims=(0,))


def _masked_curve_points(preds: Tensor, target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-sorted-sample ``(fps, tps, pos_total)`` with tie-group-end counts,
    along dim 0 (``(N,)`` or ``(N, C)`` with an ``(N,)`` mask)."""
    mask = valid if preds.ndim == 1 else valid[:, None].expand_as(preds)
    score = torch.where(mask, preds.to(torch.float32), float("-inf"))
    pos = torch.where(mask, (target == 1).to(torch.float32), 0.0)
    score_s, order = torch.sort(score, dim=0, descending=True)
    pos_s = torch.gather(pos, 0, order)
    valid_s = torch.gather(mask, 0, order)

    tps = torch.cumsum(pos_s, dim=0)
    fps = torch.cumsum(torch.where(valid_s, 1.0 - pos_s, 0.0), dim=0)

    # each position adopts the cumulative counts at its tie group's END: the
    # cumsums never decrease, so that is the smallest group-end value at or
    # after the position (the JAX package's reverse cummin)
    boundary = torch.cat([score_s[1:] != score_s[:-1], torch.ones_like(score_s[:1], dtype=torch.bool)], dim=0)
    tps_end = _reverse_cummin(torch.where(boundary, tps, float("inf")))
    fps_end = _reverse_cummin(torch.where(boundary, fps, float("inf")))
    return fps_end, tps_end, tps[-1]


def masked_binary_auroc(preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
    """AUROC over the valid entries (static shapes). Ties and padding add
    zero-width trapezoids, so the value equals the distinct-threshold
    computation on the valid subset; a single-class stream gives the 0/0
    NaN, as the exact curve's division does."""
    fps, tps, pos_total = _masked_curve_points(preds, target, valid)
    neg_total = torch.sum(valid) - pos_total
    tpr = tps / pos_total
    fpr = fps / neg_total
    # prepend the (0, 0) point; duplicates add zero area
    zero = torch.zeros_like(tpr[:1])
    tpr = torch.cat([zero, tpr], dim=0)
    fpr = torch.cat([zero, fpr], dim=0)
    return torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0, dim=0)


def masked_binary_average_precision(preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
    """Average precision over the valid entries (static shapes):
    ``Σ (recall_i − recall_{i−1}) · precision_i`` over descending thresholds;
    tie duplicates and padding carry ``Δrecall = 0``."""
    fps, tps, pos_total = _masked_curve_points(preds, target, valid)
    # the guard matters only at padding duplicates (Δrecall 0), where a NaN
    # would still poison the sum
    precision = tps / torch.clamp(tps + fps, min=METRIC_EPS)
    recall = tps / pos_total
    recall_prev = torch.cat([torch.zeros_like(recall[:1]), recall[:-1]], dim=0)
    return torch.sum((recall - recall_prev) * precision, dim=0)
