"""Scale-invariant signal-to-noise ratio.

Counterpart of ``metrics_tpu/functional/audio/si_snr.py``: SI-SNR is SI-SDR
with mean-centered signals.
"""
from metrics_tpu_torch.functional.audio.si_sdr import si_sdr
from metrics_tpu_torch.utilities.data import Tensor


def si_snr(preds: Tensor, target: Tensor) -> Tensor:
    """Scale-invariant signal-to-noise ratio (SI-SNR).

    Args:
        preds: shape ``[..., time]``
        target: shape ``[..., time]``

    Returns:
        si-snr value of shape ``[...]``

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import si_snr
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> print(f"{si_snr(preds, target):.2f}")
        15.09
    """
    return si_sdr(target=target, preds=preds, zero_mean=True)
