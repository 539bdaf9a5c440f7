"""Signal-to-noise ratio.

Counterpart of ``metrics_tpu/functional/audio/snr.py``: 10*log10 of signal
power over residual power, guarded by the input dtype's eps (``snr.py:36``),
batched over leading dims.
"""
import torch

from metrics_tpu_torch.functional.audio.si_sdr import _dtype_eps
from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import Tensor


def snr(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    r"""Signal-to-noise ratio: :math:`10\log_{10}(P_{signal}/P_{noise})`.

    Args:
        preds: shape ``[..., time]``
        target: shape ``[..., time]``
        zero_mean: if True, mean-center ``preds`` and ``target`` over time first

    Returns:
        snr value of shape ``[...]``

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import snr
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> print(f"{snr(preds, target):.2f}")
        16.18
    """
    _check_same_shape(preds, target)
    eps = _dtype_eps(preds)

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    noise = target - preds
    ratio = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(ratio)
