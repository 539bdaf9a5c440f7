"""Functional regression metrics (counterpart of ``metrics_tpu/functional/regression/``)."""
from metrics_tpu_torch.functional.regression.cosine_similarity import cosine_similarity  # noqa: F401
from metrics_tpu_torch.functional.regression.explained_variance import explained_variance  # noqa: F401
from metrics_tpu_torch.functional.regression.mean_absolute_error import mean_absolute_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mean_absolute_percentage_error import (  # noqa: F401
    mean_absolute_percentage_error,
)
from metrics_tpu_torch.functional.regression.mean_relative_error import mean_relative_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mean_squared_error import mean_squared_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mean_squared_log_error import mean_squared_log_error  # noqa: F401
from metrics_tpu_torch.functional.regression.pearson import pearson_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.regression.psnr import psnr  # noqa: F401
from metrics_tpu_torch.functional.regression.r2score import r2score  # noqa: F401
from metrics_tpu_torch.functional.regression.spearman import spearman_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.regression.ssim import ssim  # noqa: F401
