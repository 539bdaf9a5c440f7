"""Threshold metrics from binned label histograms.

Counterpart of the histogram half of ``metrics_tpu/kernels/sketches.py``
(``:62-172``): the curve functions that reconstruct AUROC, ROC, the
precision-recall curve and average precision from the per-bin score counts
of :func:`~metrics_tpu_torch.kernels.binned_counts.label_score_histograms`,
treating each bin as one prediction tie group, plus :func:`grid_index` and
:func:`clipped_count`. The result equals the exact computation whenever no
two samples share a bin and degrades smoothly (O(1/num_bins)) otherwise.

Convention shared by every ``hist_*`` function: ``pos_hist``/``neg_hist``
hold per-bin counts over the LAST axis (leading axes are classes or labels),
bin b covering scores in ``[edge_b, edge_{b+1})`` of an ascending grid. All
are plain float32 tensor math, safe under ``torch.func.vmap`` (the keyed
compute fans them out per tenant). The CDF grid, the Spearman grid and the
reservoir wait for the regression and retrieval metrics that use them.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.kernels.binned_counts import _bin_index
from metrics_tpu_torch.utilities.data import METRIC_EPS, Tensor

__all__ = [
    "clipped_count",
    "grid_index",
    "hist_auroc",
    "hist_average_precision",
    "hist_precision_recall_curve",
    "hist_roc",
]


def _rev_cumsum(x: Tensor) -> Tensor:
    """Inclusive cumulative sum from the top bin down, along the last axis."""
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), dim=-1), (-1,))


def hist_auroc(pos_hist: Tensor, neg_hist: Tensor) -> Tensor:
    """AUROC from label histograms: the Mann-Whitney U with half credit for
    within-bin ties (the trapezoid over the per-bin ROC segments).

    Degenerate single-label streams divide 0/0 -> NaN, as the exact curves
    do.
    """
    pos = pos_hist.to(torch.float32)
    neg = neg_hist.to(torch.float32)
    p_total = torch.sum(pos, dim=-1)
    n_total = torch.sum(neg, dim=-1)
    pos_above = _rev_cumsum(pos) - pos  # positives in strictly higher bins
    u = torch.sum(neg * (pos_above + 0.5 * pos), dim=-1)
    return u / (p_total * n_total)


def _desc_counts(pos_hist: Tensor, neg_hist: Tensor) -> Tuple[Tensor, Tensor]:
    """(tps, fps) cumulative counts walking thresholds DOWN the bin grid:
    position k holds the counts at threshold = lower edge of the k-th bin
    from the top (every sample in that bin and above)."""
    tps = torch.cumsum(torch.flip(pos_hist.to(torch.float32), (-1,)), dim=-1)
    fps = torch.cumsum(torch.flip(neg_hist.to(torch.float32), (-1,)), dim=-1)
    return tps, fps


def _bin_edges(num_bins: int, lo: float, hi: float, device: torch.device) -> Tensor:
    """Ascending lower bin edges (``num_bins`` values in [lo, hi))."""
    return lo + (hi - lo) * torch.arange(num_bins, dtype=torch.float32, device=device) / num_bins


def hist_roc(pos_hist: Tensor, neg_hist: Tensor, lo: float = 0.0, hi: float = 1.0) -> Tuple[Tensor, Tensor, Tensor]:
    """(fpr, tpr, thresholds) from label histograms: ``num_bins + 1`` curve
    points at descending thresholds (the exact ROC's orientation), starting
    from the (0, 0) point at threshold ``hi``."""
    num_bins = pos_hist.shape[-1]
    tps, fps = _desc_counts(pos_hist, neg_hist)
    p_total = tps[..., -1:]
    n_total = fps[..., -1:]
    zero = torch.zeros(tps.shape[:-1] + (1,), dtype=torch.float32, device=tps.device)
    tpr = torch.cat([zero, tps / p_total], dim=-1)
    fpr = torch.cat([zero, fps / n_total], dim=-1)
    edges = _bin_edges(num_bins, lo, hi, tps.device)
    thresholds = torch.cat([torch.tensor([hi], dtype=torch.float32, device=tps.device), torch.flip(edges, (0,))])
    return fpr, tpr, thresholds


def hist_precision_recall_curve(
    pos_hist: Tensor, neg_hist: Tensor, lo: float = 0.0, hi: float = 1.0
) -> Tuple[Tensor, Tensor, Tensor]:
    """(precision, recall, thresholds) at the ascending bin edges, with the
    (1, 0) endpoint appended: the :class:`BinnedPrecisionRecallCurve` output
    convention (``num_bins + 1`` curve values over ``num_bins`` thresholds)."""
    tps_desc, fps_desc = _desc_counts(pos_hist, neg_hist)
    tps = torch.flip(tps_desc, (-1,))  # ascending thresholds
    fps = torch.flip(fps_desc, (-1,))
    p_total = tps_desc[..., -1:]
    precision = (tps + METRIC_EPS) / (tps + fps + METRIC_EPS)
    recall = tps / torch.clamp(p_total, min=METRIC_EPS)
    one = torch.ones(precision.shape[:-1] + (1,), dtype=precision.dtype, device=precision.device)
    zero = torch.zeros(recall.shape[:-1] + (1,), dtype=recall.dtype, device=recall.device)
    precision = torch.cat([precision, one], dim=-1)
    recall = torch.cat([recall, zero], dim=-1)
    return precision, recall, _bin_edges(pos_hist.shape[-1], lo, hi, tps.device)


def hist_average_precision(pos_hist: Tensor, neg_hist: Tensor) -> Tensor:
    """AP = sum of delta-recall times precision over descending thresholds,
    each bin one tie group. No-positive streams divide 0/0 -> NaN, like the
    exact recall."""
    tps, fps = _desc_counts(pos_hist, neg_hist)
    p_total = tps[..., -1:]
    precision = tps / torch.clamp(tps + fps, min=METRIC_EPS)
    recall = tps / p_total
    recall_prev = torch.cat(
        [torch.zeros(recall.shape[:-1] + (1,), dtype=recall.dtype, device=recall.device), recall[..., :-1]], dim=-1
    )
    return torch.sum((recall - recall_prev) * precision, dim=-1)


def grid_index(x: Tensor, num_bins: int, lo: float, hi: float) -> Tensor:
    """int32 bin index of each value on the static ascending grid;
    out-of-range values clip into the edge bins (count them with
    :func:`clipped_count`) and NaN goes to bin 0, as in
    :func:`~metrics_tpu_torch.kernels.binned_counts.label_score_histograms`."""
    return _bin_index(x.to(torch.float32), num_bins, lo, hi).to(torch.int32)


def clipped_count(x: Tensor, lo: float, hi: float) -> Tensor:
    """How many values fell outside [lo, hi] (clipped into an edge bin), as float32."""
    return torch.sum((x < lo) | (x > hi)).to(torch.float32)
