"""Normalized discounted cumulative gain.

Counterpart of ``metrics_tpu/functional/retrieval/ndcg.py``: targets may
hold graded (non-binary, also fractional) relevance.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.retrieval.precision import _by_score, _check_k, _per_row
from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utilities.data import Tensor


def _dcg_at_k(sorted_target: Tensor, k: Any) -> Tensor:
    """Discounted cumulative gain of the first ``k`` entries of each sorted row."""
    sorted_target = sorted_target.to(torch.float32)
    k = _per_row(k, sorted_target)
    positions = torch.arange(sorted_target.shape[-1], dtype=torch.float32, device=sorted_target.device)
    discount = torch.log2(positions + 2.0)
    return torch.sum(sorted_target / discount * (positions < k), dim=-1)


def _retrieval_normalized_dcg_from_sorted(sorted_target: Tensor, k: Any) -> Tensor:
    """nDCG@k given targets sorted by descending score.

    The ideal order sorts each row's (non-negative) relevances descending;
    zero padding sorts to the tail and adds no gain. Queries with zero total
    relevance evaluate to 0."""
    sorted_target = sorted_target.to(torch.float32)
    ideal_target = -torch.sort(-sorted_target, dim=-1).values
    dcg = _dcg_at_k(sorted_target, k)
    idcg = _dcg_at_k(ideal_target, k)
    return torch.where(idcg > 0, dcg / torch.where(idcg > 0, idcg, 1.0), 0.0)


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """nDCG@k of a single query; ``target`` may hold graded (non-binary) relevance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_normalized_dcg
        >>> preds = torch.tensor([.1, .2, .3, 4, 70])
        >>> target = torch.tensor([10, 0, 0, 1, 5])
        >>> print(f"{retrieval_normalized_dcg(preds, target):.4f}")
        0.6957
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=True)
    _check_k(k)
    if k is None:
        k = preds.shape[-1]
    return _retrieval_normalized_dcg_from_sorted(_by_score(preds, target), k)
