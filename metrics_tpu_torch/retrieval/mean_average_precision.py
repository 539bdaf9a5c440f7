"""RetrievalMAP module.

Counterpart of ``metrics_tpu/retrieval/mean_average_precision.py``.
"""
from metrics_tpu_torch.functional.retrieval.average_precision import _retrieval_average_precision_from_sorted
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.utilities.data import Tensor


class RetrievalMAP(RetrievalMetric):
    """Mean average precision over queries.

    The constructor's arguments (``empty_target_action``, ``padded``,
    ``sketched``, the lifecycle arguments and ``device``) are documented on
    :class:`~metrics_tpu_torch.retrieval.retrieval_metric.RetrievalMetric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMAP
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> rmap = RetrievalMAP(device="cpu")
        >>> rmap(preds, target, indexes=indexes)
        tensor(0.7917)
    """

    higher_is_better = True

    def _metric_rows(self, target_rows: Tensor, lengths: Tensor) -> Tensor:
        return _retrieval_average_precision_from_sorted(target_rows)
