"""Module metrics of the classification path (counterpart of ``metrics_tpu/classification/``)."""
from metrics_tpu_torch.classification.accuracy import Accuracy  # noqa: F401
from metrics_tpu_torch.classification.auc import AUC  # noqa: F401
from metrics_tpu_torch.classification.auroc import AUROC  # noqa: F401
from metrics_tpu_torch.classification.average_precision import AveragePrecision  # noqa: F401
from metrics_tpu_torch.classification.binned_precision_recall import (  # noqa: F401
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
)
from metrics_tpu_torch.classification.cohen_kappa import CohenKappa  # noqa: F401
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix  # noqa: F401
from metrics_tpu_torch.classification.f_beta import F1, FBeta  # noqa: F401
from metrics_tpu_torch.classification.hamming_distance import HammingDistance  # noqa: F401
from metrics_tpu_torch.classification.hinge import Hinge  # noqa: F401
from metrics_tpu_torch.classification.iou import IoU  # noqa: F401
from metrics_tpu_torch.classification.kldivergence import KLDivergence  # noqa: F401
from metrics_tpu_torch.classification.matthews_corrcoef import MatthewsCorrcoef  # noqa: F401
from metrics_tpu_torch.classification.precision_recall import Precision, Recall  # noqa: F401
from metrics_tpu_torch.classification.precision_recall_curve import PrecisionRecallCurve  # noqa: F401
from metrics_tpu_torch.classification.roc import ROC  # noqa: F401
from metrics_tpu_torch.classification.specificity import Specificity  # noqa: F401
from metrics_tpu_torch.classification.stat_scores import StatScores  # noqa: F401
