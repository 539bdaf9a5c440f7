"""Area under a curve (trapezoidal rule).

Counterpart of ``metrics_tpu/functional/classification/auc.py``.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.data import Tensor, to_host


def _auc_update(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    if x.ndim > 1:
        x = torch.squeeze(x)
    if y.ndim > 1:
        y = torch.squeeze(y)
    if x.ndim > 1 or y.ndim > 1:
        raise ValueError(
            f"Expected both `x` and `y` tensor to be 1d, but got tensors with dimension {x.ndim} and {y.ndim}"
        )
    if x.numel() != y.numel():
        raise ValueError(
            f"Expected the same number of elements in `x` and `y` tensor but received {x.numel()} and {y.numel()}"
        )
    return x, y


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float) -> Tensor:
    return direction * torch.trapezoid(y.to(torch.float32), x.to(torch.float32))


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    if reorder:
        x_idx = torch.argsort(x, stable=True)
        x, y = x[x_idx], y[x_idx]

    dx = x[1:] - x[:-1]
    decreasing, monotone = to_host(torch.stack([torch.any(dx < 0), torch.all(dx <= 0)]))
    if decreasing:
        if monotone:
            direction = -1.0
        else:
            raise ValueError(
                "The `x` tensor is neither increasing or decreasing. Try setting the reorder argument to `True`."
            )
    else:
        direction = 1.0
    return _auc_compute_without_check(x, y, direction)


def auc(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Trapezoidal area under the (x, y) curve (float32)."""
    x, y = _auc_update(torch.as_tensor(x), torch.as_tensor(y))
    return _auc_compute(x, y, reorder=reorder)
