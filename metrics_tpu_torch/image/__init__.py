"""Image metrics (counterpart of ``metrics_tpu/image/``): ``FID``, ``IS``,
``KID`` with the InceptionV3 network, ``PSNR`` and ``SSIM``."""
from metrics_tpu_torch.image.fid import FID  # noqa: F401
from metrics_tpu_torch.image.inception import IS  # noqa: F401
from metrics_tpu_torch.image.kid import KID  # noqa: F401
from metrics_tpu_torch.image.psnr import PSNR  # noqa: F401
from metrics_tpu_torch.image.ssim import SSIM  # noqa: F401
