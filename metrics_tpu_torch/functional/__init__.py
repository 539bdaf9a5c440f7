"""Stateless functional metrics (counterpart of ``metrics_tpu/functional/``): each is
a plain function on tensors, split into ``_update``/``_compute`` halves that the
module metrics reuse."""
from metrics_tpu_torch.functional.audio import si_sdr, si_snr, snr  # noqa: F401
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
from metrics_tpu_torch.functional.image_gradients import image_gradients  # noqa: F401
from metrics_tpu_torch.functional.nlp import bleu_score  # noqa: F401
from metrics_tpu_torch.functional.regression import (  # noqa: F401
    cosine_similarity,
    explained_variance,
    mean_absolute_error,
    mean_absolute_percentage_error,
    mean_relative_error,
    mean_squared_error,
    mean_squared_log_error,
    pearson_corrcoef,
    psnr,
    r2score,
    spearman_corrcoef,
    ssim,
)
from metrics_tpu_torch.functional.retrieval import (  # noqa: F401
    retrieval_average_precision,
    retrieval_fall_out,
    retrieval_normalized_dcg,
    retrieval_precision,
    retrieval_recall,
    retrieval_reciprocal_rank,
)
from metrics_tpu_torch.functional.self_supervised import embedding_similarity  # noqa: F401
