"""Image metrics (counterpart of ``metrics_tpu/image/``): ``PSNR`` and ``SSIM``;
FID, KID and IS with the Inception network are still to be ported."""
from metrics_tpu_torch.image.psnr import PSNR  # noqa: F401
from metrics_tpu_torch.image.ssim import SSIM  # noqa: F401
