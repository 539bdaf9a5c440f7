"""SI_SNR module metric.

Counterpart of ``metrics_tpu/audio/si_snr.py``; its states are those of
:class:`~metrics_tpu_torch.audio.si_sdr.SI_SDR`.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.audio.si_snr import si_snr
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor


class SI_SNR(Metric):
    """Scale-invariant signal-to-noise ratio, averaged over all samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SI_SNR
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_snr = SI_SNR(device="cpu")
        >>> print(f"{si_snr(preds, target):.2f}")
        15.09
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
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
        self.add_state("sum_si_snr", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample SI-SNR values."""
        si_snr_batch = si_snr(preds=preds, target=target)
        self.sum_si_snr = self.sum_si_snr + torch.sum(si_snr_batch).to(self.sum_si_snr.dtype)
        self.total = self.total + si_snr_batch.numel()

    def compute(self) -> Tensor:
        """Average SI-SNR over everything seen so far."""
        return self.sum_si_snr / self.total
