"""Stateless functional metrics (counterpart of ``metrics_tpu/functional/``): each is
a plain function on tensors, split into ``_update``/``_compute`` halves that the
module metrics reuse."""
from metrics_tpu_torch.functional.classification import (  # noqa: F401
    accuracy,
    confusion_matrix,
    f1,
    fbeta,
    precision,
    precision_recall,
    recall,
    stat_scores,
)
