"""Image gradients by one-step finite differences.

Counterpart of ``metrics_tpu/functional/image_gradients.py``: ``dy``/``dx``
with the last row/column zero (``image_gradients.py:24-31``), the TF
convention (the difference ``I(x+1, y) - I(x, y)`` stored at ``(x, y)``).
"""
from typing import Tuple

import torch
import torch.nn.functional as F

from metrics_tpu_torch.utilities.data import Tensor


def _image_gradients_validate(img: Tensor) -> None:
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"The `img` expects a value of <torch.Tensor> type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]

    dy = F.pad(dy, (0, 0, 0, 1))
    dx = F.pad(dx, (0, 1, 0, 0))

    return dy, dx


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """Finite-difference gradients of a batch of images.

    Args:
        img: an ``(N, C, H, W)`` image tensor

    Returns:
        tuple ``(dy, dx)``, each of shape ``(N, C, H, W)``

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import image_gradients
        >>> image = torch.arange(0, 1*1*5*5, dtype=torch.float32).reshape(1, 1, 5, 5)
        >>> dy, dx = image_gradients(image)
        >>> dy[0, 0, :, :]
        tensor([[5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [0., 0., 0., 0., 0.]])
    """
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
