"""Audio metrics (counterpart of ``metrics_tpu/audio/``)."""
from metrics_tpu_torch.audio.si_sdr import SI_SDR  # noqa: F401
from metrics_tpu_torch.audio.si_snr import SI_SNR  # noqa: F401
from metrics_tpu_torch.audio.snr import SNR  # noqa: F401
