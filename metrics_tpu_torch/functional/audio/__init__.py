"""Functional audio metrics (counterpart of ``metrics_tpu/functional/audio/``)."""
from metrics_tpu_torch.functional.audio.si_sdr import si_sdr  # noqa: F401
from metrics_tpu_torch.functional.audio.si_snr import si_snr  # noqa: F401
from metrics_tpu_torch.functional.audio.snr import snr  # noqa: F401
