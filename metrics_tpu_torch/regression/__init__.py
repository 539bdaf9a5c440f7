"""Module regression metrics (counterpart of ``metrics_tpu/regression/``)."""
from metrics_tpu_torch.regression.cosine_similarity import CosineSimilarity  # noqa: F401
from metrics_tpu_torch.regression.explained_variance import ExplainedVariance  # noqa: F401
from metrics_tpu_torch.regression.mean_absolute_error import MeanAbsoluteError  # noqa: F401
from metrics_tpu_torch.regression.mean_absolute_percentage_error import MeanAbsolutePercentageError  # noqa: F401
from metrics_tpu_torch.regression.mean_squared_error import MeanSquaredError  # noqa: F401
from metrics_tpu_torch.regression.mean_squared_log_error import MeanSquaredLogError  # noqa: F401
from metrics_tpu_torch.regression.pearson import PearsonCorrcoef  # noqa: F401
from metrics_tpu_torch.regression.psnr import PSNR  # noqa: F401
from metrics_tpu_torch.regression.r2score import R2Score  # noqa: F401
from metrics_tpu_torch.regression.spearman import SpearmanCorrcoef  # noqa: F401
from metrics_tpu_torch.regression.ssim import SSIM  # noqa: F401
