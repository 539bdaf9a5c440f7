"""PyTorch/CUDA port of ``metrics_tpu`` for NVIDIA Hopper (H100).

The package stands alone: it imports ``torch`` and never ``jax`` or any
``metrics_tpu`` module. Its module paths mirror the JAX package's, and each
module's docstring names its counterpart there. Metrics keep their states as
tensors on an explicit device (``device=``, default ``"cuda"``); the hot
counting loops run hand-written CUDA kernels for ``sm_90a``
(``metrics_tpu_torch/csrc``), built with ``nvcc`` at first use.

The slices so far cover the stat-scores and confusion-matrix classification
path (``Accuracy``, ``Precision``, ``Recall``, ``FBeta``, ``F1``,
``StatScores``, ``ConfusionMatrix`` and ``MetricCollection``) and the
multi-tenant keyed state over it (``KeyedMetric`` and
``MultiTenantCollection``).
"""
from metrics_tpu_torch.classification import (  # noqa: F401
    F1,
    Accuracy,
    ConfusionMatrix,
    FBeta,
    Precision,
    Recall,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection  # noqa: F401
from metrics_tpu_torch.metric import Metric  # noqa: F401
from metrics_tpu_torch.wrappers import KeyedMetric, MultiTenantCollection  # noqa: F401
