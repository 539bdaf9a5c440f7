"""Stateless functional metrics (counterpart of ``metrics_tpu/functional/``): each is
a plain function on tensors, split into ``_update``/``_compute`` halves that the
module metrics reuse."""
from metrics_tpu_torch.functional.classification import (  # noqa: F401
    accuracy,
    auc,
    auroc,
    average_precision,
    confusion_matrix,
    f1,
    fbeta,
    precision,
    precision_recall,
    precision_recall_curve,
    recall,
    roc,
    stat_scores,
)
