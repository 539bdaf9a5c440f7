"""Scale-invariant signal-to-distortion ratio.

Counterpart of ``metrics_tpu/functional/audio/si_sdr.py``: the optimal
scaling of ``preds`` onto ``target`` and a 10*log10 energy ratio over the
trailing (time) axis, leading dims batched. The eps guard is the input
dtype's own (``si_sdr.py:38``): float64 inputs stay in float64, float16
inputs take float16's eps of 9.8e-4, and integer inputs raise
``ValueError``, as ``jnp.finfo`` of an integer dtype does.
"""
import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import Tensor


def _dtype_eps(x: Tensor) -> float:
    """The machine epsilon of ``x``'s floating dtype; raise on any other."""
    if not torch.is_floating_point(x):
        raise ValueError(f"data type {x.dtype} not inexact")
    return torch.finfo(x.dtype).eps


def si_sdr(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """Scale-invariant signal-to-distortion ratio (SI-SDR).

    Args:
        preds: shape ``[..., time]``
        target: shape ``[..., time]``
        zero_mean: if True, mean-center ``preds`` and ``target`` over time first

    Returns:
        si-sdr value of shape ``[...]``

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import si_sdr
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> print(f"{si_sdr(preds, target):.2f}")
        18.40
    """
    _check_same_shape(preds, target)
    eps = _dtype_eps(preds)

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (
        torch.sum(target**2, dim=-1, keepdim=True) + eps
    )
    target_scaled = alpha * target
    noise = target_scaled - preds

    ratio = (torch.sum(target_scaled**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(ratio)
