"""CUDA kernels for Hopper behind the hot metric ops.

Counterpart of ``metrics_tpu/kernels/``. Each kernel module exposes
``<op>_cuda``, the wrapper that launches the hand-written kernel for a CUDA
tensor (and runs the plain version for a CPU tensor), and ``<op>_torch``,
the plain PyTorch version the tests and ``chip_smoke.py`` hold the kernel
against. Each launch adds one to the op's count
(:func:`~metrics_tpu_torch.kernels._common.launch_count`).

* ``stat_scores_counts`` — fused tp/fp/tn/fn counting for the stat-scores family;
* ``confmat_counts`` — confusion-matrix counting;
* ``segment_scatter_add``, ``segment_scatter_max``, ``segment_scatter_min`` —
  the keyed update's routing of per-row deltas to tenants.
"""
from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_cuda, confmat_counts_torch  # noqa: F401
from metrics_tpu_torch.kernels.stat_scores import stat_scores_counts_cuda, stat_scores_counts_torch  # noqa: F401
from metrics_tpu_torch.kernels.segment_scatter import (  # noqa: F401
    segment_scatter_add_cuda,
    segment_scatter_add_torch,
    segment_scatter_max_cuda,
    segment_scatter_max_torch,
    segment_scatter_min_cuda,
    segment_scatter_min_torch,
)
