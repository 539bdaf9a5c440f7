"""Recall@k for information retrieval.

Counterpart of ``metrics_tpu/functional/retrieval/recall.py``.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.retrieval.precision import _by_score, _check_k, _per_row
from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utilities.data import Tensor


def _retrieval_recall_from_sorted(sorted_target: Tensor, k: Any) -> Tensor:
    """Hits in the top-``k`` over all positives, targets sorted by descending score."""
    sorted_target = sorted_target.to(torch.float32)
    k = _per_row(k, sorted_target)
    positions = torch.arange(sorted_target.shape[-1], device=sorted_target.device)
    relevant = torch.sum(sorted_target * (positions < k), dim=-1)
    total_pos = torch.sum(sorted_target, dim=-1)
    return torch.where(total_pos > 0, relevant / torch.clamp(total_pos, min=1), 0.0)


def retrieval_recall(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Recall@k of a single query's predictions with respect to binary targets.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_recall
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_recall(preds, target, k=2)
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _check_k(k)
    if k is None:
        k = preds.shape[-1]
    return _retrieval_recall_from_sorted(_by_score(preds, target), k)
