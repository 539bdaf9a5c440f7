"""Retrieval metrics (counterpart of ``metrics_tpu/retrieval/``)."""
from metrics_tpu_torch.retrieval.mean_average_precision import RetrievalMAP  # noqa: F401
from metrics_tpu_torch.retrieval.mean_reciprocal_rank import RetrievalMRR  # noqa: F401
from metrics_tpu_torch.retrieval.retrieval_fallout import RetrievalFallOut  # noqa: F401
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric  # noqa: F401
from metrics_tpu_torch.retrieval.retrieval_ndcg import RetrievalNormalizedDCG  # noqa: F401
from metrics_tpu_torch.retrieval.retrieval_precision import RetrievalPrecision  # noqa: F401
from metrics_tpu_torch.retrieval.retrieval_recall import RetrievalRecall  # noqa: F401

__all__ = [
    "RetrievalFallOut",
    "RetrievalMAP",
    "RetrievalMetric",
    "RetrievalMRR",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalRecall",
]
