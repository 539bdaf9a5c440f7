"""CUDA kernels for Hopper behind the hot metric ops.

Counterpart of ``metrics_tpu/kernels/``. Each kernel module exposes
``<op>_cuda``, the wrapper that launches the hand-written kernel for a CUDA
tensor (and runs the plain version for a CPU tensor), and ``<op>_torch``,
the plain PyTorch version the tests and ``chip_smoke.py`` hold the kernel
against. Each launch adds one to the op's count
(:func:`~metrics_tpu_torch.kernels._common.launch_count`).

* ``stat_scores_counts`` — fused tp/fp/tn/fn counting for the stat-scores family;
* ``confmat_counts`` — confusion-matrix counting.
"""
from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_cuda, confmat_counts_torch  # noqa: F401
from metrics_tpu_torch.kernels.stat_scores import stat_scores_counts_cuda, stat_scores_counts_torch  # noqa: F401
