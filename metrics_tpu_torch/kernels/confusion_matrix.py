"""Confusion-matrix counting: ``confmat[t, p] += 1``.

Counterpart of ``metrics_tpu/kernels/confusion_matrix.py``. Two formulations:

* :func:`confmat_counts_torch`, the plain version: ``torch.bincount`` over
  the flat index ``t * C + p``, with every pair whose ``t`` or ``p`` lies
  outside ``[0, C)`` sent to one extra bin that is cut off.
* :func:`confmat_counts_cuda`, the wrapper of the hand-written kernel
  ``csrc/confusion_matrix.cu`` (which replaces the Pallas
  ``_confmat_kernel``): an integer-atomic histogram, privatised in shared
  memory for small C. It takes a CUDA tensor to the kernel and a CPU tensor
  to the plain version.

Both DROP an out-of-range pair, as the JAX package's ``confmat_counts_pallas``
does; its ``confmat_counts_xla`` wraps the flat index instead. The metric
path never reaches that case: ``_confusion_matrix_update`` raises on the
host first.
"""
import ctypes
from typing import Union

import torch

from metrics_tpu_torch.kernels._common import (
    check_launch,
    current_stream_handle,
    kernel_device,
    kernel_function,
    note_kernel_dispatch,
    require_capability,
)
from metrics_tpu_torch.utilities.data import Tensor, check_device

_OP = "confmat_counts"
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p,
)
#: largest C whose C*C flat index fits the kernel's int32 output indexing
_MAX_CLASSES = 46340


def confmat_counts_torch(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """``(C, C)`` int32 counts of the (target, pred) pairs; out-of-range pairs dropped."""
    p = preds.reshape(-1).long()
    t = target.reshape(-1).long()
    cells = num_classes * num_classes
    keep = (p >= 0) & (p < num_classes) & (t >= 0) & (t < num_classes)
    flat = torch.where(keep, t * num_classes + p, cells)
    bins = torch.bincount(flat, minlength=cells + 1)[:cells]
    return bins.to(torch.int32).reshape(num_classes, num_classes)


def confmat_counts_cuda(
    preds: Tensor, target: Tensor, num_classes: int, device: Union[str, torch.device] = "cuda"
) -> Tensor:
    """``(C, C)`` int32 counts of ``(N,)`` int32/int64 label pairs lying on ``device``.

    On a CUDA device the kernel counts; on the CPU the plain version does.
    Raises on inputs the kernel does not take.
    """
    device = kernel_device(device)
    check_device(device, preds, target)
    if preds.ndim != 1 or preds.shape != target.shape:
        raise ValueError(f"expected preds and target of one shape (N,), got {tuple(preds.shape)} and"
                         f" {tuple(target.shape)}")
    if not 1 <= num_classes <= _MAX_CLASSES:
        raise ValueError(f"{_OP} takes 1 <= num_classes <= {_MAX_CLASSES}, got {num_classes}")
    if device.type == "cpu":
        note_kernel_dispatch(_OP, "torch")
        return confmat_counts_torch(preds, target, num_classes)
    if device.type != "cuda":
        raise ValueError(f"{_OP} runs on a CUDA or the CPU device, not on {device}")
    if preds.dtype != target.dtype or preds.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{_OP} takes two int32 or two int64 inputs, got {preds.dtype} and {target.dtype}")
    if not (preds.is_contiguous() and target.is_contiguous()):
        raise ValueError(f"{_OP} takes contiguous inputs")
    require_capability(device)
    return _counts_cuda(preds, target, num_classes, device)


def _counts_cuda(preds: Tensor, target: Tensor, num_classes: int, device: torch.device) -> Tensor:
    """One zero fill and one call into the C library, which makes ``device``
    current for its launch on that device's current stream."""
    out = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=device)
    n = preds.shape[0]
    if n:
        err = kernel_function("confmat_counts_launch", _ARGTYPES)(
            preds.data_ptr(), target.data_ptr(), n, num_classes, preds.element_size(), out.data_ptr(), device.index,
            current_stream_handle(device))
        check_launch(_OP, err)
        note_kernel_dispatch(_OP, "cuda")
    return out
