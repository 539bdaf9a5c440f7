"""SI_SDR module metric.

Counterpart of ``metrics_tpu/audio/si_sdr.py``: two ``"sum"`` states, a
float32 value sum and an int32 sample count (the JAX package's
``jnp.asarray(0)`` without x64). Both are tensors, so a keyed ``SI_SDR()``
routes both through the segment-scatter kernel B3 in one launch; the
count stays exact while one tenant's samples in one batch stay below 2^24.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.audio.si_sdr import si_sdr
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor


class SI_SDR(Metric):
    """Scale-invariant signal-to-distortion ratio, averaged over all samples.

    Args:
        zero_mean: if True, mean-center ``preds``/``target`` before scaling
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SI_SDR
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_sdr = SI_SDR(device="cpu")
        >>> print(f"{si_sdr(preds, target):.2f}")
        18.40
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
        self.add_state("sum_si_sdr", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample SI-SDR values."""
        si_sdr_batch = si_sdr(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_si_sdr = self.sum_si_sdr + torch.sum(si_sdr_batch).to(self.sum_si_sdr.dtype)
        self.total = self.total + si_sdr_batch.numel()

    def compute(self) -> Tensor:
        """Average SI-SDR over everything seen so far."""
        return self.sum_si_sdr / self.total
