"""Average precision for information retrieval.

Counterpart of ``metrics_tpu/functional/retrieval/average_precision.py``.
"""
import torch

from metrics_tpu_torch.functional.retrieval.precision import _by_score
from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utilities.data import Tensor


def _retrieval_average_precision_from_sorted(sorted_target: Tensor) -> Tensor:
    """AP of each query given its targets sorted by descending score.

    Trailing zero padding (the module path's ``(num_queries, max_len)``
    layout) adds neither a hit nor a positive. Queries with no positive
    target evaluate to 0."""
    sorted_target = sorted_target.to(torch.float32)
    positions = torch.arange(1, sorted_target.shape[-1] + 1, dtype=torch.float32, device=sorted_target.device)
    hits = torch.cumsum(sorted_target, dim=-1)
    precision_at_hit = torch.where(sorted_target > 0, hits / positions, 0.0)
    total_pos = torch.sum(sorted_target, dim=-1)
    return torch.where(total_pos > 0, torch.sum(precision_at_hit, dim=-1) / torch.clamp(total_pos, min=1), 0.0)


def retrieval_average_precision(preds: Tensor, target: Tensor) -> Tensor:
    """Average precision of a single query's predictions with respect to binary targets.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_average_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_average_precision(preds, target)
        tensor(0.8333)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    return _retrieval_average_precision_from_sorted(_by_score(preds, target))
