"""Deprecated location of ``SSIM``.

Counterpart of ``metrics_tpu/regression/ssim.py``: the alias of
:class:`metrics_tpu_torch.image.ssim.SSIM`, with the JAX package's
deprecation warning.
"""
from typing import Any, Callable, Optional, Sequence, Union
from warnings import warn

import torch

from metrics_tpu_torch.image.ssim import SSIM as _SSIM


class SSIM(_SSIM):
    """.. deprecated::
        ``SSIM`` was moved to ``metrics_tpu_torch.image.ssim``.
    """

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: str = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        warn(
            "This `SSIM` was moved to `metrics_tpu_torch.image.ssim` and this shell will be removed"
            " in a future release. Use `metrics_tpu_torch.image.ssim.SSIM` instead.",
            DeprecationWarning,
        )
        super().__init__(
            kernel_size=kernel_size,
            sigma=sigma,
            reduction=reduction,
            data_range=data_range,
            k1=k1,
            k2=k2,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
