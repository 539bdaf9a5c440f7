"""Structural similarity index measure.

Counterpart of ``metrics_tpu/functional/regression/ssim.py``: every window
statistic is computed over the stacked ``(5*B, C, H, W)`` batch in one
pass. The separable Gaussian window runs as two 1-D depthwise
``F.conv2d(groups=C)`` passes over the reflect-padded stack, the JAX
package's large-image form (its band-matrix matmuls are a choice made for
the TPU's matrix unit and are not carried over).

The reflect padding gathers along precomputed reflected positions (an
``arange`` folded on the device), so it also pads an image whose side is at
most the pad, bouncing as often as ``jnp.pad(mode="reflect")`` does, where
``F.pad`` refuses. The convolutions run in full float32 on the card (no
TF32): the variance cancellation ``E[X^2] - mu^2`` amplifies any rounding of
the window means. Integer images compute in float32.
"""
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from metrics_tpu_torch.functional.regression.spearman import _dtype_name
from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import Tensor, full_fp32
from metrics_tpu_torch.utilities.distributed import reduce


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype, device: torch.device) -> Tensor:
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, step=1, dtype=dtype, device=device)
    gauss = torch.exp(-torch.square(dist / sigma) / 2)
    return gauss / gauss.sum()  # (kernel_size,)


def _reflect_index(size: int, pad: int, device: torch.device) -> Tensor:
    """Positions ``-pad .. size + pad - 1`` reflected into ``[0, size)``
    (mirror without repeating the edge), as many times as it takes."""
    idx = torch.arange(-pad, size + pad, device=device)
    if size == 1:
        return torch.zeros_like(idx)
    period = 2 * (size - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= size, period - idx, idx)


def _ssim_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {_dtype_name(preds)} and target: {_dtype_name(target)}."
        )
    _check_same_shape(preds, target)
    if len(preds.shape) != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _ssim_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tensor:
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")
    if not preds.is_floating_point():
        # integer images compute in float32 (the port's float policy): the
        # window, the pad and the convolutions. The JAX package builds its
        # window in the images' integer dtype, where it truncates to zeros.
        preds, target = preds.to(torch.float32), target.to(torch.float32)

    if data_range is None:
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    channel = preds.shape[1]
    dtype, device = preds.dtype, preds.device
    pad_w = (kernel_size[0] - 1) // 2
    pad_h = (kernel_size[1] - 1) // 2

    # every window statistic over the stacked 5B batch (reflect-pad commutes
    # with elementwise products)
    stack = torch.cat((preds, target, preds * preds, target * target, preds * target))
    h, w = preds.shape[-2], preds.shape[-1]
    padded = stack.index_select(-2, _reflect_index(h, pad_h, device)).index_select(-1, _reflect_index(w, pad_w, device))
    kern_h = _gaussian(kernel_size[0], sigma[0], dtype, device).reshape(1, 1, kernel_size[0], 1).expand(channel, 1, -1, 1)
    kern_w = _gaussian(kernel_size[1], sigma[1], dtype, device).reshape(1, 1, 1, kernel_size[1]).expand(channel, 1, 1, -1)
    with full_fp32(device):
        outputs = F.conv2d(padded, kern_h, groups=channel)
        outputs = F.conv2d(outputs, kern_w, groups=channel)
    batch = preds.shape[0]
    mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = (
        outputs[i * batch:(i + 1) * batch] for i in range(5)
    )

    mu_pred_sq = torch.square(mu_pred)
    mu_target_sq = torch.square(mu_target)
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = e_pred_sq - mu_pred_sq
    sigma_target_sq = e_target_sq - mu_target_sq
    sigma_pred_target = e_pred_target - mu_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2

    ssim_idx = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)
    ssim_idx = ssim_idx[..., pad_h:ssim_idx.shape[-2] - pad_h, pad_w:ssim_idx.shape[-1] - pad_w]

    return reduce(ssim_idx, reduction)


def ssim(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tensor:
    """Structural similarity index measure.

    Args:
        preds: estimated image, shape ``(B, C, H, W)``
        target: ground-truth image, shape ``(B, C, H, W)``
        kernel_size: size of the gaussian window
        sigma: standard deviation of the gaussian window
        reduction: ``'elementwise_mean'`` | ``'sum'`` | ``'none'``
        data_range: range of the image; if None determined from the data
        k1: SSIM stability constant (luminance)
        k2: SSIM stability constant (contrast)

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import ssim
        >>> preds = torch.linspace(0, 1, 16 * 16).reshape(1, 1, 16, 16)
        >>> target = preds * 0.75
        >>> print(f"{ssim(preds, target):.3f}")
        0.924
    """
    preds, target = _ssim_update(preds, target)
    return _ssim_compute(preds, target, kernel_size, sigma, reduction, data_range, k1, k2)
