"""Precision@k for information retrieval.

Counterpart of ``metrics_tpu/functional/retrieval/precision.py``, with its
``_check_k`` and ``_per_row`` helpers. Precision@k divides by ``k``, not by
``min(k, length)``, as the reference does.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utilities.data import Tensor


def _check_k(k: Optional[int]) -> None:
    if k is not None and not (isinstance(k, int) and k > 0):
        raise ValueError("`k` has to be a positive integer or None")


def _per_row(x: Any, ref: Tensor) -> Any:
    """Broadcast a per-query value against ``(num_queries, max_len)`` rows:
    a ``(num_queries,)`` tensor gains a trailing axis; a Python number or a
    0-d tensor stays as it is."""
    if isinstance(x, Tensor) and x.ndim == ref.ndim - 1 and x.ndim > 0:
        return x.unsqueeze(-1)
    return x


def _by_score(preds: Tensor, target: Tensor) -> Tensor:
    """``target`` in descending order of ``preds``: ties keep their order,
    NaN scores go last (``jnp.argsort(-preds, stable=True)``)."""
    return target[torch.sort(-preds, stable=True).indices]


def _retrieval_precision_from_sorted(sorted_target: Tensor, k: Any) -> Tensor:
    """Hits in the top-``k`` over ``k``, given targets sorted by descending
    score. ``k`` is a number or a per-query tensor (the module path passes
    the query lengths when ``k=None``). Queries with no positive target
    evaluate to 0."""
    sorted_target = sorted_target.to(torch.float32)
    k = _per_row(k, sorted_target)
    positions = torch.arange(sorted_target.shape[-1], device=sorted_target.device)
    relevant = torch.sum(sorted_target * (positions < k), dim=-1)
    has_pos = torch.sum(sorted_target, dim=-1) > 0
    k_per_query = k.squeeze(-1) if isinstance(k, Tensor) and k.ndim > 1 else k
    return torch.where(has_pos, relevant / k_per_query, 0.0)


def retrieval_precision(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Precision@k of a single query's predictions with respect to binary targets.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_precision(preds, target, k=2)
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _check_k(k)
    if k is None:
        k = preds.shape[-1]
    return _retrieval_precision_from_sorted(_by_score(preds, target), k)
