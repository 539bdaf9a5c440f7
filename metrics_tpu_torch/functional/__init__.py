"""Stateless functional metrics (counterpart of ``metrics_tpu/functional/``): each is
a plain function on tensors, split into ``_update``/``_compute`` halves that the
module metrics reuse."""
from metrics_tpu_torch.functional.classification import (  # noqa: F401
    accuracy,
    auc,
    auroc,
    average_precision,
    cohen_kappa,
    confusion_matrix,
    dice_score,
    f1,
    fbeta,
    hamming_distance,
    hinge,
    iou,
    kldivergence,
    matthews_corrcoef,
    precision,
    precision_recall,
    precision_recall_curve,
    recall,
    roc,
    specificity,
    stat_scores,
)
