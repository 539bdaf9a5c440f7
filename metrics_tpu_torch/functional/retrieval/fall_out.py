"""Fall-out@k for information retrieval.

Counterpart of ``metrics_tpu/functional/retrieval/fall_out.py``.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.retrieval.precision import _by_score, _check_k, _per_row
from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utilities.data import Tensor


def _retrieval_fall_out_from_sorted(sorted_target: Tensor, k: Any, num_valid: Any) -> Tensor:
    """Retrieved negatives in the top-``k`` over all negatives.

    Padding would read as negatives, so the true query length ``num_valid``
    masks it out of both numerator and denominator. Queries with no
    negative target evaluate to 0."""
    sorted_target = sorted_target.to(torch.float32)
    k = _per_row(k, sorted_target)
    num_valid = _per_row(num_valid, sorted_target)
    positions = torch.arange(sorted_target.shape[-1], device=sorted_target.device)
    negatives = (1.0 - sorted_target) * (positions < num_valid)
    retrieved_neg = torch.sum(negatives * (positions < k), dim=-1)
    total_neg = torch.sum(negatives, dim=-1)
    return torch.where(total_neg > 0, retrieved_neg / torch.clamp(total_neg, min=1), 0.0)


def retrieval_fall_out(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Fall-out@k of a single query's predictions with respect to binary targets.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_fall_out
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_fall_out(preds, target, k=2)
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _check_k(k)
    if k is None:
        k = preds.shape[-1]
    return _retrieval_fall_out_from_sorted(_by_score(preds, target), k, preds.shape[-1])
