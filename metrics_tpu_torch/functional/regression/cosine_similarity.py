"""Cosine similarity.

Counterpart of ``metrics_tpu/functional/regression/cosine_similarity.py``:
inputs are promoted to at least float32, so a float64 input keeps its
precision.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import Tensor


def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    dtype = torch.promote_types(torch.promote_types(preds.dtype, target.dtype), torch.float32)
    return preds.to(dtype), target.to(dtype)


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    dot_product = torch.sum(preds * target, dim=-1)
    preds_norm = torch.linalg.vector_norm(preds, dim=-1)
    target_norm = torch.linalg.vector_norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    reduction_mapping = {"sum": torch.sum, "mean": torch.mean, "none": lambda x: x, None: lambda x: x}
    return reduction_mapping[reduction](similarity)


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Row-wise cosine similarity with sum/mean/none reduction.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cosine_similarity
        >>> target = torch.tensor([[1., 2, 3, 4], [1., 2, 3, 4]])
        >>> preds = torch.tensor([[1., 2, 3, 4], [-1., -2, -3, -4]])
        >>> print(cosine_similarity(preds, target, 'none'))
        tensor([ 1., -1.])
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)
