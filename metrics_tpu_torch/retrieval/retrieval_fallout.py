"""RetrievalFallOut module.

Counterpart of ``metrics_tpu/retrieval/retrieval_fallout.py``: a query is
"empty" when it has no *negative* target, and the default policy scores it
1 (it retrieved no negative, the benign outcome). Like the JAX package's,
it takes no ``sketched`` mode.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.retrieval.fall_out import _retrieval_fall_out_from_sorted
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.utilities.data import Tensor


class RetrievalFallOut(RetrievalMetric):
    """Mean fall-out@k over queries.

    The constructor's arguments (``empty_target_action``, ``padded``,
    ``k``, the lifecycle arguments and ``device``) are documented on
    :class:`~metrics_tpu_torch.retrieval.retrieval_metric.RetrievalMetric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalFallOut
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> fo = RetrievalFallOut(k=2, device="cpu")
        >>> fo(preds, target, indexes=indexes)
        tensor(0.5000)
    """

    higher_is_better = False
    _empty_relevance = "negative"
    _uses_k = True

    def __init__(
        self,
        empty_target_action: str = "pos",
        padded: bool = False,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        k: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(
            empty_target_action=empty_target_action,
            padded=padded,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            k=k,
            device=device,
        )

    def _metric_rows(self, target_rows: Tensor, lengths: Tensor) -> Tensor:
        return _retrieval_fall_out_from_sorted(target_rows, self._resolve_k(lengths), lengths)
