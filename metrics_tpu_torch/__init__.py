"""PyTorch/CUDA port of ``metrics_tpu`` for NVIDIA Hopper (H100).

The package stands alone: it imports ``torch`` and never ``jax`` or any
``metrics_tpu`` module. Its module paths mirror the JAX package's, and each
module's docstring names its counterpart there. Metrics keep their states as
tensors on an explicit device (``device=``, default ``"cuda"``); the hot
counting loops run hand-written CUDA kernels for ``sm_90a``
(``metrics_tpu_torch/csrc``), built with ``nvcc`` at first use.

The slices so far cover the stat-scores and confusion-matrix classification
path (``Accuracy``, ``Precision``, ``Recall``, ``FBeta``, ``F1``,
``Specificity``, ``StatScores``, ``ConfusionMatrix``, ``IoU``,
``CohenKappa``, ``MatthewsCorrcoef`` and ``MetricCollection``), the other
classification metrics (``HammingDistance``, ``Hinge``, ``KLDivergence``,
the functional ``dice_score``), ``AverageMeter``, the arithmetic of metrics
(``CompositionalMetric``), the multi-tenant keyed state (``KeyedMetric``
and ``MultiTenantCollection``), the curve metrics (``AUROC``,
``AveragePrecision``, ``ROC``, ``PrecisionRecallCurve``, ``AUC`` and the
binned curves), exact or ``sketched=True``, the epoch-end sync over
``torch.distributed`` (``utilities/distributed.py``, ``transport/``), the
telemetry core (``observability``: counters, events, histograms,
collective spans, ``snapshot()``, ``render_prometheus()``), and the serving
plane (``serving``: ``AdmissionQueue``, ``SLOScheduler``, the staging ring;
``compute_async`` on the background engine of ``utilities/async_sync.py``;
``resilience``: ``RetryPolicy``, ``DeadlineBudget``, ``CircuitBreaker``),
the compiled step (``jit_forward``, ``warmup``, ``update_many``: one
CUDA graph per input signature, replayed over the metric's own state; the
curves' ``capacity=`` mode, ``BufferOverflowError``), and the regression
family (``MeanSquaredError``, ``MeanAbsoluteError``,
``MeanAbsolutePercentageError``, ``MeanSquaredLogError``,
``ExplainedVariance``, ``R2Score``, ``PearsonCorrcoef``,
``CosineSimilarity`` and ``SpearmanCorrcoef``, with their streaming,
``capacity=`` and ``sketched=True`` modes) with the image metrics ``PSNR``
and ``SSIM``, and the retrieval family (``RetrievalMAP``, ``RetrievalMRR``,
``RetrievalPrecision``, ``RetrievalRecall``, ``RetrievalNormalizedDCG``,
``RetrievalFallOut``) in its flat, ``padded=True`` and ``sketched=True``
(query reservoir) modes, and the rest of the metric inventory: the audio
metrics (``SNR``, ``SI_SNR``, ``SI_SDR``), ``BootStrapper``, and ``FID``,
``KID`` and ``IS`` on an InceptionV3 carried across from the JAX package's
Flax net (``image/inception_net.py``), with the functional ``bleu_score``,
``embedding_similarity`` and ``image_gradients``; the durability plane
(``durability``: ``CheckpointManager`` in the JAX package's on-disk format,
``TenantSpiller``, ``KeyedMetric.grow``/``compact``), the resilience plane's
fault plans, failure detector and membership epoch (``FaultPlan``,
``FailureDetector``, ``Membership``), and the transports' true subgroups,
``ShardedTransport`` and ``Hierarchy``.
"""
from metrics_tpu_torch.__about__ import __version__  # noqa: F401
from metrics_tpu_torch.audio import SI_SDR, SI_SNR, SNR  # noqa: F401
from metrics_tpu_torch.average import AverageMeter  # noqa: F401
from metrics_tpu_torch.classification import (  # noqa: F401
    AUC,
    AUROC,
    F1,
    ROC,
    Accuracy,
    AveragePrecision,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
    CohenKappa,
    ConfusionMatrix,
    FBeta,
    HammingDistance,
    Hinge,
    IoU,
    KLDivergence,
    MatthewsCorrcoef,
    Precision,
    PrecisionRecallCurve,
    Recall,
    Specificity,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection  # noqa: F401
from metrics_tpu_torch.image import FID, IS, KID, PSNR, SSIM  # noqa: F401
from metrics_tpu_torch.metric import CompositionalMetric, Metric  # noqa: F401
from metrics_tpu_torch.regression import (  # noqa: F401
    CosineSimilarity,
    ExplainedVariance,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    PearsonCorrcoef,
    R2Score,
    SpearmanCorrcoef,
)
from metrics_tpu_torch.retrieval import (  # noqa: F401
    RetrievalFallOut,
    RetrievalMAP,
    RetrievalMetric,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalRecall,
)
from metrics_tpu_torch.utilities.capped_buffer import BufferOverflowError  # noqa: F401
from metrics_tpu_torch.wrappers import BootStrapper, KeyedMetric, MultiTenantCollection  # noqa: F401
from metrics_tpu_torch import serving  # noqa: F401 E402
from metrics_tpu_torch.serving import AdmissionQueue, SLOScheduler  # noqa: F401 E402
from metrics_tpu_torch import resilience  # noqa: F401 E402
from metrics_tpu_torch.utilities.distributed import Hierarchy, hierarchical_axis  # noqa: F401 E402
from metrics_tpu_torch import durability  # noqa: F401 E402
from metrics_tpu_torch.durability import CheckpointManager, TenantSpiller  # noqa: F401 E402
from metrics_tpu_torch.resilience import (  # noqa: F401 E402
    CircuitBreaker,
    DeadlineBudget,
    FailureDetector,
    FaultPlan,
    FaultSpec,
    Membership,
    RetryPolicy,
)
