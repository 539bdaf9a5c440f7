"""Reciprocal rank for information retrieval.

Counterpart of ``metrics_tpu/functional/retrieval/reciprocal_rank.py``.
"""
import torch

from metrics_tpu_torch.functional.retrieval.precision import _by_score
from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utilities.data import Tensor


def _retrieval_reciprocal_rank_from_sorted(sorted_target: Tensor) -> Tensor:
    """1 / (position of the first hit) given targets sorted by descending
    score; queries with no positive evaluate to 0. ``argmax`` of the hit
    mask (as int32: PyTorch has no ``argmax`` of a bool tensor on the CPU)
    gives the first maximum, as ``jnp.argmax`` does."""
    sorted_target = sorted_target.to(torch.float32)
    first_hit = torch.argmax((sorted_target > 0).to(torch.int32), dim=-1)
    has_hit = torch.sum(sorted_target, dim=-1) > 0
    return torch.where(has_hit, 1.0 / (first_hit + 1.0), 0.0)


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor) -> Tensor:
    """Reciprocal rank of the first relevant document of a single query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_reciprocal_rank
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, False])
        >>> retrieval_reciprocal_rank(preds, target)
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    return _retrieval_reciprocal_rank_from_sorted(_by_score(preds, target))
