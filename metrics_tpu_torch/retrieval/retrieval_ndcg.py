"""RetrievalNormalizedDCG module.

Counterpart of ``metrics_tpu/retrieval/retrieval_ndcg.py``.
"""
from metrics_tpu_torch.functional.retrieval.ndcg import _retrieval_normalized_dcg_from_sorted
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.utilities.data import Tensor


class RetrievalNormalizedDCG(RetrievalMetric):
    """Mean nDCG@k over queries; targets may hold graded relevance.

    The constructor's arguments (``empty_target_action``, ``padded``,
    ``sketched``, ``k``, the lifecycle arguments and ``device``) are
    documented on :class:`~metrics_tpu_torch.retrieval.retrieval_metric.RetrievalMetric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalNormalizedDCG
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> ndcg = RetrievalNormalizedDCG(device="cpu")
        >>> print(f"{ndcg(preds, target, indexes=indexes):.4f}")
        0.8467
    """

    higher_is_better = True
    allow_non_binary_target = True
    _uses_k = True

    def _metric_rows(self, target_rows: Tensor, lengths: Tensor) -> Tensor:
        return _retrieval_normalized_dcg_from_sorted(target_rows, self._resolve_k(lengths))
