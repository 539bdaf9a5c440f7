"""Spearman rank correlation.

Counterpart of ``metrics_tpu/functional/regression/spearman.py``: Pearson on
fractional ranks, computed without a host loop. The JAX package sorts once
with two keys (invalid slots last, then the value) and un-permutes with a
second sort; PyTorch's sort takes one key, so the port sorts stably by the
value and then stably by the invalid key, which gives the same order
(invalid slots after every valid one, ``+inf`` included), and un-permutes
with a ``scatter``. Tie groups come from
:func:`~metrics_tpu_torch.utilities.data.tie_group_bounds`; each takes the
mean of its 1-based rank block.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import Tensor, tie_group_bounds


def _rank_data(data: Tensor) -> Tensor:
    """Fractional ranks (1-based); ties get the mean of their rank block."""
    return _masked_rank(data, torch.ones(data.shape, dtype=torch.bool, device=data.device))


def _masked_rank(data: Tensor, valid: Tensor) -> Tensor:
    """Fractional ranks among the valid entries (invalid slots order after
    every valid one and receive meaningless ranks: mask them out downstream).

    Ranks come back in the input's floating dtype (integers promote), so
    float64 streams keep full precision (ranks beyond 2^23 stay exact) and
    integer ties still rank fractionally.
    """
    dtype = data.dtype if data.is_floating_point() else torch.promote_types(data.dtype, torch.float32)
    n = data.shape[0]
    x = data.to(dtype)
    invalid_key = (~valid).to(torch.int32)
    # two stable sorts: by the value, then by the invalid key
    by_value = torch.sort(x, stable=True).indices
    orig = by_value[torch.sort(invalid_key[by_value], stable=True).indices]
    inv_s, x_s = invalid_key[orig], x[orig]
    changed = (inv_s[1:] != inv_s[:-1]) | (x_s[1:] != x_s[:-1])
    start_idx, end_idx = tie_group_bounds(changed)
    # at least float32, so half-precision dtypes don't overflow on start + end (~2n)
    frac_dtype = torch.promote_types(dtype, torch.float32)
    frac = ((start_idx + end_idx).to(frac_dtype) / 2 + 1).to(dtype)
    # out of place, so that torch.func.vmap batches it (the pure bootstrap's compute)
    return torch.scatter(torch.empty((n,), dtype=dtype, device=data.device), 0, orig, frac)


def _spearman_corrcoef_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {_dtype_name(preds)} and target: {_dtype_name(target)}."
        )
    _check_same_shape(preds, target)
    preds = torch.squeeze(preds)
    target = torch.squeeze(target)
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    return preds, target


def _dtype_name(x: Tensor) -> str:
    """The dtype as the JAX package names it in its messages (``float32``)."""
    return str(x.dtype).replace("torch.", "")


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    preds = _rank_data(preds)
    target = _rank_data(target)

    preds_diff = preds - torch.mean(preds)
    target_diff = target - torch.mean(target)

    cov = torch.mean(preds_diff * target_diff)
    preds_std = torch.sqrt(torch.mean(preds_diff * preds_diff))
    target_std = torch.sqrt(torch.mean(target_diff * target_diff))

    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0)


def masked_spearman_corrcoef(preds: Tensor, target: Tensor, valid: Tensor, eps: float = 1e-6) -> Tensor:
    """Spearman correlation over the valid entries, at a fixed shape.

    Powers ``SpearmanCorrcoef(capacity=...)``: ranks from the masked rank,
    then a mask-weighted Pearson with the same eps guard and clipping as
    :func:`_spearman_corrcoef_compute`.
    """
    rp = _masked_rank(preds, valid)
    rt = _masked_rank(target, valid)
    m = valid.to(rp.dtype)
    n = torch.clamp(torch.sum(m), min=1.0)
    mean_p = torch.sum(rp * m) / n
    mean_t = torch.sum(rt * m) / n
    dp = (rp - mean_p) * m
    dt = (rt - mean_t) * m
    cov = torch.sum(dp * dt) / n
    std_p = torch.sqrt(torch.sum(dp * dp) / n)
    std_t = torch.sqrt(torch.sum(dt * dt) / n)
    return torch.clamp(cov / (std_p * std_t + eps), -1.0, 1.0)


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman rank correlation (Pearson on fractional ranks).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spearman_corrcoef
        >>> target = torch.tensor([3., -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> print(f"{spearman_corrcoef(preds, target):.2f}")
        1.00
    """
    preds, target = _spearman_corrcoef_update(preds, target)
    return _spearman_corrcoef_compute(preds, target)
