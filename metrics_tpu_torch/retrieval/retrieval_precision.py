"""RetrievalPrecision module.

Counterpart of ``metrics_tpu/retrieval/retrieval_precision.py``.
"""
from metrics_tpu_torch.functional.retrieval.precision import _retrieval_precision_from_sorted
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.utilities.data import Tensor


class RetrievalPrecision(RetrievalMetric):
    """Mean precision@k over queries (``k=None`` uses each query's full length).

    The constructor's arguments (``empty_target_action``, ``padded``,
    ``sketched``, ``k``, the lifecycle arguments and ``device``) are
    documented on :class:`~metrics_tpu_torch.retrieval.retrieval_metric.RetrievalMetric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> p2 = RetrievalPrecision(k=2, device="cpu")
        >>> p2(preds, target, indexes=indexes)
        tensor(0.5000)
    """

    higher_is_better = True
    _uses_k = True

    def _metric_rows(self, target_rows: Tensor, lengths: Tensor) -> Tensor:
        return _retrieval_precision_from_sorted(target_rows, self._resolve_k(lengths))
