"""Module metrics of the classification path (counterpart of ``metrics_tpu/classification/``)."""
from metrics_tpu_torch.classification.accuracy import Accuracy  # noqa: F401
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix  # noqa: F401
from metrics_tpu_torch.classification.f_beta import F1, FBeta  # noqa: F401
from metrics_tpu_torch.classification.precision_recall import Precision, Recall  # noqa: F401
from metrics_tpu_torch.classification.stat_scores import StatScores  # noqa: F401
