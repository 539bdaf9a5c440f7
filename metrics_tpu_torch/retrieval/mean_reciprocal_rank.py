"""RetrievalMRR module.

Counterpart of ``metrics_tpu/retrieval/mean_reciprocal_rank.py``.
"""
from metrics_tpu_torch.functional.retrieval.reciprocal_rank import _retrieval_reciprocal_rank_from_sorted
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.utilities.data import Tensor


class RetrievalMRR(RetrievalMetric):
    """Mean reciprocal rank over queries.

    The constructor's arguments (``empty_target_action``, ``padded``,
    ``sketched``, the lifecycle arguments and ``device``) are documented on
    :class:`~metrics_tpu_torch.retrieval.retrieval_metric.RetrievalMetric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMRR
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> mrr = RetrievalMRR(device="cpu")
        >>> mrr(preds, target, indexes=indexes)
        tensor(0.7500)
    """

    higher_is_better = True

    def _metric_rows(self, target_rows: Tensor, lengths: Tensor) -> Tensor:
        return _retrieval_reciprocal_rank_from_sorted(target_rows)
