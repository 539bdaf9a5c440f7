"""Cohen's kappa.

Counterpart of ``metrics_tpu/functional/classification/cohen_kappa.py``:
observed against chance-expected agreement from the confusion matrix (kernel
B2), with none/linear/quadratic disagreement weights.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)
from metrics_tpu_torch.utilities.data import Tensor

_cohen_kappa_update = _confusion_matrix_update


def _cohen_kappa_compute(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    confmat = _confusion_matrix_compute(confmat).float()
    n_classes = confmat.shape[0]
    sum0 = torch.sum(confmat, dim=0, keepdim=True)
    sum1 = torch.sum(confmat, dim=1, keepdim=True)
    expected = sum1 @ sum0 / torch.sum(sum0)

    if weights is None:
        w_mat = 1.0 - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        grid = torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device)
        diff = grid[None, :] - grid[:, None]
        w_mat = torch.abs(diff) if weights == "linear" else diff**2
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )

    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def cohen_kappa(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    threshold: float = 0.5,
) -> Tensor:
    """Cohen's kappa inter-annotator agreement score."""
    confmat = _cohen_kappa_update(preds, target, num_classes, threshold)
    return _cohen_kappa_compute(confmat, weights)
