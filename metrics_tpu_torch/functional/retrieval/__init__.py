"""Functional retrieval metrics (counterpart of ``metrics_tpu/functional/retrieval/``).

Every public function scores a *single query* ``f(preds, target, [k])``.
Each is a thin wrapper over a ``_*_from_sorted`` row function on the
targets already sorted by descending score (ties in arrival order, NaN
scores last). The module path
(:class:`~metrics_tpu_torch.retrieval.RetrievalMetric`) applies the same row
functions to a padded ``(num_queries, max_len)`` layout, every query at once.
"""
from metrics_tpu_torch.functional.retrieval.average_precision import retrieval_average_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.fall_out import retrieval_fall_out  # noqa: F401
from metrics_tpu_torch.functional.retrieval.ndcg import retrieval_normalized_dcg  # noqa: F401
from metrics_tpu_torch.functional.retrieval.precision import retrieval_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.recall import retrieval_recall  # noqa: F401
from metrics_tpu_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank  # noqa: F401

__all__ = [
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
