"""Fixed-size sketches: threshold metrics from binned label histograms,
the CDF sketch, the joint rank grid and the priority reservoir.

Counterpart of ``metrics_tpu/kernels/sketches.py``: the curve
functions that reconstruct AUROC, ROC, the precision-recall curve and
average precision from the per-bin score counts of
:func:`~metrics_tpu_torch.kernels.binned_counts.label_score_histograms`,
treating each bin as one prediction tie group, plus :func:`grid_index` and
:func:`clipped_count`. The result equals the exact computation whenever no
two samples share a bin and degrades smoothly (O(1/num_bins)) otherwise.

The CDF sketch (:func:`cdf_sketch_update`, :func:`cdf_sketch_cdf`,
:func:`cdf_sketch_quantile`) and the joint rank grid behind
``SpearmanCorrcoef(sketched=True)`` (:func:`joint_grid_update`,
:func:`spearman_from_grid`) are plain XLA in the JAX package and plain
PyTorch here. Their counts are added with ``index_add`` into the flat view
of the grid (``ix * By + iy`` where the JAX package writes
``grid.at[ix, iy].add(1.0)``): no value is read to the host, so an update
can be captured into a CUDA graph. (``torch.bincount`` would read the
largest index to the host on the card.)

Convention shared by every ``hist_*`` function: ``pos_hist``/``neg_hist``
hold per-bin counts over the LAST axis (leading axes are classes or labels),
bin b covering scores in ``[edge_b, edge_{b+1})`` of an ascending grid. All
are plain float32 tensor math, safe under ``torch.func.vmap`` (the keyed
compute fans them out per tenant).

The reservoir (:func:`uniform_hash`, :func:`weighted_priority`,
:func:`bounded_priority_keep`, ``sketches.py:252-291``) backs
``RetrievalMetric(sketched=True)``. :func:`uniform_hash` reproduces the
JAX package's uint32 murmur3 finalizer bit for bit in int64 arithmetic
(PyTorch has no shift of ``uint32``): each product is split into 16-bit
halves so no intermediate passes 2^63, and every step is masked to 32
bits. :func:`bounded_priority_keep` is the JAX package's two-key stable
``lax.sort`` as two stable sorts, by the tie-break and then by the key.
Every constant is a Python scalar, so a reservoir update can be captured
into a CUDA graph.
"""
from typing import Any, Tuple

import torch

from metrics_tpu_torch.kernels.binned_counts import _bin_index
from metrics_tpu_torch.utilities.data import METRIC_EPS, Tensor

__all__ = [
    "cdf_sketch_cdf",
    "cdf_sketch_quantile",
    "cdf_sketch_update",
    "clipped_count",
    "grid_index",
    "hist_auroc",
    "hist_average_precision",
    "hist_precision_recall_curve",
    "hist_roc",
    "joint_grid_update",
    "spearman_from_grid",
    "bounded_priority_keep",
    "uniform_hash",
    "weighted_priority",
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


def cdf_sketch_update(counts: Tensor, x: Tensor, lo: float, hi: float) -> Tensor:
    """A batch accumulated into a ``(num_bins,)`` CDF sketch (merge = ``+``)."""
    idx = grid_index(x.reshape(-1), counts.shape[-1], lo, hi).long()
    return counts.index_add(0, idx, torch.ones(idx.shape, dtype=counts.dtype, device=counts.device))


def cdf_sketch_cdf(counts: Tensor, v: Tensor, lo: float, hi: float) -> Tensor:
    """P(X <= v) under the sketch (bin mass attributed to the bin midpoint)."""
    num_bins = counts.shape[-1]
    total = torch.clamp(torch.sum(counts), min=1.0)
    idx = grid_index(v, num_bins, lo, hi).long()
    cum = torch.cumsum(counts, dim=0)
    below = torch.where(idx > 0, cum[torch.clamp(idx - 1, min=0)], 0.0)
    return (below + counts[idx] * 0.5) / total


def cdf_sketch_quantile(counts: Tensor, q: Any, lo: float, hi: float) -> Tensor:
    """Interpolated quantile(s): walk the cumulative mass to the target rank
    and interpolate linearly inside the crossing bin."""
    num_bins = counts.shape[-1]
    total = torch.clamp(torch.sum(counts), min=1.0)
    cum = torch.cumsum(counts, dim=0)
    rank = torch.as_tensor(q, dtype=torch.float32, device=counts.device) * total
    idx = torch.searchsorted(cum, rank.reshape(-1), side="left").reshape(rank.shape)
    idx = torch.clamp(idx, 0, num_bins - 1)
    prev = torch.where(idx > 0, cum[torch.clamp(idx - 1, min=0)], 0.0)
    in_bin = torch.clamp(counts[idx], min=METRIC_EPS)
    frac = torch.clamp((rank - prev) / in_bin, 0.0, 1.0)
    width = (hi - lo) / num_bins
    return lo + (idx.to(torch.float32) + frac) * width


def joint_grid_update(
    grid: Tensor, x: Tensor, y: Tensor, x_range: Tuple[float, float], y_range: Tuple[float, float]
) -> Tuple[Tensor, Tensor]:
    """``(x, y)`` pairs accumulated into a ``(Bx, By)`` joint grid; returns
    the advanced grid and this batch's out-of-range (clipped) pair count, as
    float32. Each pair adds one at the flat index ``ix * By + iy``."""
    bx, by = grid.shape
    x = x.reshape(-1)
    y = y.reshape(-1)
    ix = grid_index(x, bx, *x_range).long()
    iy = grid_index(y, by, *y_range).long()
    clipped = torch.sum((x < x_range[0]) | (x > x_range[1]) | (y < y_range[0]) | (y > y_range[1])).to(torch.float32)
    ones = torch.ones(ix.shape, dtype=grid.dtype, device=grid.device)
    return grid.reshape(-1).index_add(0, ix * by + iy, ones).reshape(bx, by), clipped


def spearman_from_grid(grid: Tensor) -> Tensor:
    """Spearman's rho from joint bin counts with midrank tie correction:
    exactly the rho of the stream discretized onto the grid (error -> 0 as
    the grid refines for continuous in-range data). An empty grid divides
    0/0 -> NaN, as the exact formula on an empty stream does."""
    g = grid.to(torch.float32)
    nx = torch.sum(g, dim=1)
    ny = torch.sum(g, dim=0)
    n = torch.sum(nx)
    # midrank of every bin: ranks 1..n, ties averaged within a bin
    rx = torch.cumsum(nx, dim=0) - nx + (nx + 1.0) / 2.0
    ry = torch.cumsum(ny, dim=0) - ny + (ny + 1.0) / 2.0
    rbar = (n + 1.0) / 2.0
    dx = rx - rbar
    dy = ry - rbar
    cov = dx @ (g @ dy)
    var_x = torch.sum(nx * dx * dx)
    var_y = torch.sum(ny * dy * dy)
    return cov / torch.sqrt(var_x * var_y)


# ---------------------------------------------------------------------------
# weighted reservoir sampling (bounded-priority sample)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul32(x: Tensor, c: int) -> Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)`` and a 32-bit
    constant, with no intermediate past 2^48."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def uniform_hash(ids: Tensor) -> Tensor:
    """Deterministic uniform in [0, 1] per integer id (murmur3 finalizer),
    float32, bit-identical to the JAX package's.

    The id's low 32 bits are hashed, as the JAX package's cast to uint32
    takes them (so ids 5 and 2^32 + 5 collide). The uint32 result is
    rounded to the nearest float32 and divided by 2^32, so a hash near 2^32
    gives exactly 1.0, as there.
    """
    x = (ids.to(torch.int64) & _MASK32) + 0x9E3779B9
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x.to(torch.float32) / 4294967296.0


def weighted_priority(uniform: Tensor, weight: Any = 1.0) -> Tensor:
    """Efraimidis-Spirakis priority: an Exp(weight) variate from a uniform.

    Keeping the ``capacity`` SMALLEST priorities draws a weighted sample
    without replacement; ``weight=1`` degrades to uniform sampling."""
    u = torch.clamp(uniform.to(torch.float32), 1e-12, 1.0)
    weight = weight.to(torch.float32) if isinstance(weight, Tensor) else float(weight)
    return -torch.log(u) / weight


def bounded_priority_keep(
    keys: Tensor, tiebreak: Tensor, values: Tuple[Tensor, ...], capacity: int
) -> Tuple[Tensor, Tensor, Tuple[Tensor, ...]]:
    """Keep the ``capacity`` rows with the smallest ``(key, tiebreak)``,
    rows equal in both in the order they came (``sketches.py:276``).

    Two stable sorts, by ``tiebreak`` and then by ``key``, give the JAX
    package's stable two-key sort; the payload columns follow by one
    gather each. Empty slots carry ``key = +inf`` and fall off the end."""
    order = torch.sort(tiebreak, stable=True).indices
    order = order[torch.sort(keys[order], stable=True).indices][:capacity]
    return keys[order], tiebreak[order], tuple(v[order] for v in values)
