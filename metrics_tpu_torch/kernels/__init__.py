"""CUDA kernels for Hopper behind the hot metric ops.

Counterpart of ``metrics_tpu/kernels/``. Each kernel module exposes
``<op>_cuda``, the wrapper that launches the hand-written kernel for a CUDA
tensor (and runs the plain version for a CPU tensor), and ``<op>_torch``,
the plain PyTorch version the tests and ``chip_smoke.py`` hold the kernel
against. Each launch adds one to the op's count
(:func:`~metrics_tpu_torch.kernels._common.launch_count`).

* ``stat_scores_counts`` — fused tp/fp/tn/fn counting for the stat-scores family;
* ``confmat_counts`` — confusion-matrix counting (and ``confmat_counts_batched``);
* ``segment_scatter_add``, ``segment_scatter_max``, ``segment_scatter_min`` —
  the keyed update's routing of per-row deltas to tenants;
* ``label_score_histograms`` — the sketched curves' per-class score
  histograms split by label (and ``label_score_histograms_batched``, a stack
  of them: the keyed rows and a bootstrap's resamples).

Beside them, as the JAX package's ``kernels`` exports them: the plain
``binned_tp_fp_fn`` and the sketch helpers of ``kernels/sketches.py`` (the
``hist_*`` curves of the histograms, the CDF sketch, the joint rank grid
and the query reservoir's hash and priorities).
"""
from metrics_tpu_torch.kernels.binned_counts import (  # noqa: F401
    binned_tp_fp_fn,
    label_score_histograms_batched_cuda,
    label_score_histograms_batched_torch,
    label_score_histograms_cuda,
    label_score_histograms_torch,
)
from metrics_tpu_torch.kernels.confusion_matrix import (  # noqa: F401
    confmat_counts_batched_cuda,
    confmat_counts_batched_torch,
    confmat_counts_cuda,
    confmat_counts_torch,
)
from metrics_tpu_torch.kernels.stat_scores import stat_scores_counts_cuda, stat_scores_counts_torch  # noqa: F401
from metrics_tpu_torch.kernels.segment_scatter import (  # noqa: F401
    segment_scatter_add_cuda,
    segment_scatter_add_torch,
    segment_scatter_max_cuda,
    segment_scatter_max_torch,
    segment_scatter_min_cuda,
    segment_scatter_min_torch,
)
from metrics_tpu_torch.kernels.sketches import (  # noqa: F401
    bounded_priority_keep,
    cdf_sketch_cdf,
    cdf_sketch_quantile,
    hist_auroc,
    hist_average_precision,
    hist_precision_recall_curve,
    hist_roc,
    joint_grid_update,
    spearman_from_grid,
    uniform_hash,
    weighted_priority,
)
