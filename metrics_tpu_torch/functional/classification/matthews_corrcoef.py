"""Matthews correlation coefficient.

Counterpart of ``metrics_tpu/functional/classification/matthews_corrcoef.py``:
from the row, column and trace sums of the confusion matrix (kernel B2).
"""
import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.utilities.data import Tensor

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: Tensor) -> Tensor:
    confmat = confmat.float()
    tk = torch.sum(confmat, dim=1)
    pk = torch.sum(confmat, dim=0)
    c = torch.trace(confmat)
    s = torch.sum(confmat)
    return (c * s - torch.sum(tk * pk)) / (torch.sqrt(s**2 - torch.sum(pk * pk)) * torch.sqrt(s**2 - torch.sum(tk * tk)))


def matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    threshold: float = 0.5,
) -> Tensor:
    """Matthews correlation coefficient of a classification."""
    confmat = _matthews_corrcoef_update(preds, target, num_classes, threshold)
    return _matthews_corrcoef_compute(confmat)
