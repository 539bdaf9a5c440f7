"""Peak signal-to-noise ratio.

Counterpart of ``metrics_tpu/functional/regression/psnr.py``: squared-error
and count partial sums (optionally over a ``dim`` subset) and a log-domain
compute. Without ``dim`` the count stays a Python int (a tensor of it would
be a copy to the card); with ``dim`` it is a fill of the sums' shape.
"""
import math
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import Tensor
from metrics_tpu_torch.utilities.distributed import reduce
from metrics_tpu_torch.utilities.prints import rank_zero_warn


def _psnr_compute(
    sum_squared_error: Tensor,
    n_obs: Union[int, Tensor],
    data_range: Tensor,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
) -> Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    psnr_vals = psnr_base_e * (10 / math.log(base))
    return reduce(psnr_vals, reduction=reduction)


def _psnr_update(
    preds: Tensor,
    target: Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[Tensor, Union[int, Tensor]]:
    _check_same_shape(preds, target)
    diff = preds - target
    if dim is None:
        return torch.sum(diff * diff), target.numel()

    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:
        # an empty ``dim`` reduces over no axis, as ``jnp.sum(x, axis=())`` does
        return diff * diff, target.numel()
    sum_squared_error = torch.sum(diff * diff, dim=dim_list)
    n_obs = math.prod(target.shape[d] for d in dim_list)
    return sum_squared_error, torch.full(sum_squared_error.shape, n_obs, device=sum_squared_error.device)


def psnr(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """Peak signal-to-noise ratio.

    Args:
        preds: estimated signal
        target: ground-truth signal
        data_range: the range of the data; if None it is determined from the
            data (max - min). Must be given when ``dim`` is not None.
        base: logarithm base
        reduction: ``'elementwise_mean'`` | ``'sum'`` | ``'none'``
        dim: dimension(s) to reduce PSNR scores over; None reduces over all

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import psnr
        >>> pred = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> print(f"{psnr(pred, target):.2f}")
        2.55
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = target.max() - target.min()
    else:
        data_range = torch.full((), float(data_range), device=target.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
