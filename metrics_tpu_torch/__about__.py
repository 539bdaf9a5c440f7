"""Version metadata of the port (counterpart of ``metrics_tpu/__about__.py``)."""
__version__ = "0.20.0"
__author__ = "metrics-tpu contributors"
__license__ = "Apache-2.0"
__docs__ = (
    "PyTorch/CUDA port of metrics_tpu for NVIDIA Hopper: the distributed metric-state engine over "
    "torch.distributed, with hand-written sm_90a kernels for the counting loops."
)
