"""Deprecated location of ``PSNR``.

Counterpart of ``metrics_tpu/regression/psnr.py``: the alias of
:class:`metrics_tpu_torch.image.psnr.PSNR`, with the JAX package's
deprecation warning.
"""
from typing import Any, Callable, Optional, Tuple, Union
from warnings import warn

import torch

from metrics_tpu_torch.image.psnr import PSNR as _PSNR


class PSNR(_PSNR):
    """.. deprecated::
        ``PSNR`` was moved to ``metrics_tpu_torch.image.psnr``.
    """

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: str = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        warn(
            "This `PSNR` was moved to `metrics_tpu_torch.image.psnr` and this shell will be removed"
            " in a future release. Use `metrics_tpu_torch.image.psnr.PSNR` instead.",
            DeprecationWarning,
        )
        super().__init__(
            data_range=data_range,
            base=base,
            reduction=reduction,
            dim=dim,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
