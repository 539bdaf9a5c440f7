"""RetrievalRecall module.

Counterpart of ``metrics_tpu/retrieval/retrieval_recall.py``.
"""
from metrics_tpu_torch.functional.retrieval.recall import _retrieval_recall_from_sorted
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.utilities.data import Tensor


class RetrievalRecall(RetrievalMetric):
    """Mean recall@k over queries (``k=None`` uses each query's full length).

    The constructor's arguments (``empty_target_action``, ``padded``,
    ``sketched``, ``k``, the lifecycle arguments and ``device``) are
    documented on :class:`~metrics_tpu_torch.retrieval.retrieval_metric.RetrievalMetric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalRecall
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> r2 = RetrievalRecall(k=2, device="cpu")
        >>> r2(preds, target, indexes=indexes)
        tensor(0.7500)
    """

    higher_is_better = True
    _uses_k = True

    def _metric_rows(self, target_rows: Tensor, lengths: Tensor) -> Tensor:
        return _retrieval_recall_from_sorted(target_rows, self._resolve_k(lengths))
