"""SNR module metric.

Counterpart of ``metrics_tpu/audio/snr.py``; its states are those of
:class:`~metrics_tpu_torch.audio.si_sdr.SI_SDR`.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.audio.snr import snr
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor


class SNR(Metric):
    """Signal-to-noise ratio, averaged over all samples.

    Args:
        zero_mean: if True, mean-center ``preds``/``target`` before the ratio
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SNR
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> snr = SNR(device="cpu")
        >>> print(f"{snr(preds, target):.2f}")
        16.18
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        zero_mean: bool = False,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.zero_mean = zero_mean
        self.add_state("sum_snr", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample SNR values."""
        snr_batch = snr(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_snr = self.sum_snr + torch.sum(snr_batch).to(self.sum_snr.dtype)
        self.total = self.total + snr_batch.numel()

    def compute(self) -> Tensor:
        """Average SNR over everything seen so far."""
        return self.sum_snr / self.total
