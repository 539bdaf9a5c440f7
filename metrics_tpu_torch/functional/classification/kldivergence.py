"""KL divergence.

Counterpart of ``metrics_tpu/functional/classification/kldivergence.py``.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import METRIC_EPS, Tensor


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, int]:
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")

    total = p.shape[0]
    if log_prob:
        measures = torch.sum(torch.exp(p) * (p - q), dim=-1)
    else:
        p = p / torch.sum(p, dim=-1, keepdim=True)
        q = q / torch.sum(q, dim=-1, keepdim=True)
        q = torch.clamp(q, min=METRIC_EPS)
        measures = torch.sum(p * torch.log(p / q), dim=-1)
    return measures, total


def _kld_compute(measures: Tensor, total: Tensor, reduction: Optional[str] = "mean") -> Tensor:
    if reduction == "sum":
        return torch.sum(measures)
    if reduction == "mean":
        return torch.sum(measures) / total
    if reduction is None or reduction == "none":
        return measures
    return measures / total


def kldivergence(p: Tensor, q: Tensor, log_prob: bool = False, reduction: Optional[str] = "mean") -> Tensor:
    """KL divergence ``D_KL(P||Q)`` over rows of distributions.

    Args:
        p: ``(N, d)`` data distribution(s).
        q: ``(N, d)`` prior/approximation distribution(s).
        log_prob: inputs are log-probabilities (already normalized).
        reduction: ``'mean' | 'sum' | 'none' | None``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import kldivergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> print(f"{kldivergence(p, q):.3f}")
        0.085
    """
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)
