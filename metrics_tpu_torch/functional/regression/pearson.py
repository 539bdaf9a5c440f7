"""Pearson correlation coefficient.

Counterpart of ``metrics_tpu/functional/regression/pearson.py``, with its
eps-guarded denominator and clipping to [-1, 1]. Integer (and boolean)
inputs compute in float32, the port's float policy (``torch.mean`` refuses
integer tensors, where ``jnp.mean`` promotes them); float inputs keep their
dtype.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import Tensor


def _pearson_check(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """The shape checks: equal shapes, 1-D after squeezing."""
    _check_same_shape(preds, target)
    preds = torch.squeeze(preds)
    target = torch.squeeze(target)
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    return preds, target


def _pearson_corrcoef_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds, target = _pearson_check(preds, target)
    return tuple(x if x.is_floating_point() else x.to(torch.float32) for x in (preds, target))


def _pearson_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    preds_diff = preds - torch.mean(preds)
    target_diff = target - torch.mean(target)

    cov = torch.mean(preds_diff * target_diff)
    preds_std = torch.sqrt(torch.mean(preds_diff * preds_diff))
    target_std = torch.sqrt(torch.mean(target_diff * target_diff))

    denom = preds_std * target_std
    denom = torch.where(denom == 0, denom + eps, denom)

    return torch.clamp(cov / denom, -1.0, 1.0)


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pearson_corrcoef
        >>> target = torch.tensor([3., -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> print(f"{pearson_corrcoef(preds, target):.4f}")
        0.9849
    """
    preds, target = _pearson_corrcoef_update(preds, target)
    return _pearson_corrcoef_compute(preds, target)
