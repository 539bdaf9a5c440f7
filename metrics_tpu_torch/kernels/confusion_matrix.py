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
* :func:`confmat_counts_batched_torch` and :func:`confmat_counts_batched_cuda`,
  the same for a ``(B, N)`` stack of pair vectors into ``(B, C, C)`` counts.
  The batched form is an entry of its own in ``csrc/confusion_matrix.cu``:
  one launch over the stack, which writes every cell of the output (a
  block's slices counted in shared memory where ``C * C`` fits there, else
  atomics into an output the entry zeroes on the stream), cell offsets in
  int64.
* :func:`confmat_counts_stacked`, the seam's call inside ``torch.func.vmap``:
  its vmap rule (``_common.vmap_stack``) hands the whole stack to the
  batched wrapper in one launch,
  as ``pallas_call``'s batching rule runs the Pallas kernel over a leading
  grid axis.

All DROP an out-of-range pair, as the JAX package's ``confmat_counts_pallas``
does; its ``confmat_counts_xla`` wraps the flat index instead. The metric
path reaches that case only inside ``torch.func.vmap``, where no value can
be read: elsewhere ``_confusion_matrix_update`` raises on the host first.
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
    vmap_stack,
)
from metrics_tpu_torch.utilities.data import Tensor, _is_batched, check_device

_OP = "confmat_counts"
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p,
)
_BATCHED_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p,
)
#: largest C whose C*C flat index fits the single form's int32 output indexing
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


def confmat_counts_batched_torch(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """``(B, C, C)`` int32 counts of each row of ``(B, N)`` label pairs; out-of-range pairs dropped."""
    b, cells = preds.shape[0], num_classes * num_classes
    p, t = preds.long(), target.long()
    keep = (p >= 0) & (p < num_classes) & (t >= 0) & (t < num_classes)
    row = torch.arange(b, device=preds.device).unsqueeze(-1) * cells
    flat = torch.where(keep, row + t * num_classes + p, b * cells)
    bins = torch.bincount(flat.reshape(-1), minlength=b * cells + 1)[: b * cells]
    return bins.to(torch.int32).reshape(b, num_classes, num_classes)


def _check_pairs(preds: Tensor, target: Tensor, num_classes: int, ndim: int) -> None:
    if preds.ndim != ndim or preds.shape != target.shape:
        shape = "(N,)" if ndim == 1 else "(B, N)"
        raise ValueError(f"expected preds and target of one shape {shape}, got {tuple(preds.shape)} and"
                         f" {tuple(target.shape)}")
    if not 1 <= num_classes <= _MAX_CLASSES:
        raise ValueError(f"{_OP} takes 1 <= num_classes <= {_MAX_CLASSES}, got {num_classes}")


def _check_cuda_inputs(preds: Tensor, target: Tensor, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{_OP} runs on a CUDA or the CPU device, not on {device}")
    if preds.dtype != target.dtype or preds.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{_OP} takes two int32 or two int64 inputs, got {preds.dtype} and {target.dtype}")
    if not (preds.is_contiguous() and target.is_contiguous()):
        raise ValueError(f"{_OP} takes contiguous inputs")
    require_capability(device)


def confmat_counts_cuda(
    preds: Tensor, target: Tensor, num_classes: int, device: Union[str, torch.device] = "cuda"
) -> Tensor:
    """``(C, C)`` int32 counts of ``(N,)`` int32/int64 label pairs lying on ``device``.

    On a CUDA device the kernel counts; on the CPU the plain version does.
    Raises on inputs the kernel does not take.
    """
    device = kernel_device(device)
    check_device(device, preds, target)
    _check_pairs(preds, target, num_classes, 1)
    if device.type == "cpu":
        note_kernel_dispatch(_OP, "torch")
        return confmat_counts_torch(preds, target, num_classes)
    _check_cuda_inputs(preds, target, device)
    return _counts_cuda(preds, target, num_classes, device)


def confmat_counts_batched_cuda(
    preds: Tensor, target: Tensor, num_classes: int, device: Union[str, torch.device] = "cuda"
) -> Tensor:
    """``(B, C, C)`` int32 counts of each row of a ``(B, N)`` stack of
    int32/int64 label pairs lying on ``device``.

    On a CUDA device the kernel counts the whole stack in one launch; on
    the CPU the plain version does. Raises on inputs the kernel does not
    take.
    """
    device = kernel_device(device)
    check_device(device, preds, target)
    _check_pairs(preds, target, num_classes, 2)
    if device.type == "cpu":
        note_kernel_dispatch(_OP, "torch")
        return confmat_counts_batched_torch(preds, target, num_classes)
    _check_cuda_inputs(preds, target, device)
    return _batched_counts_cuda(preds, target, num_classes, device)


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


def _batched_counts_cuda(preds: Tensor, target: Tensor, num_classes: int, device: torch.device) -> Tensor:
    """The batched form of :func:`_counts_cuda`: one call into the C library,
    whose launch writes every cell of the ``(B, C, C)`` output, so it is
    allocated without a fill."""
    b, n = preds.shape
    out = torch.empty((b, num_classes, num_classes), dtype=torch.int32, device=device)
    if b:
        err = kernel_function("confmat_counts_batched_launch", _BATCHED_ARGTYPES)(
            preds.data_ptr(), target.data_ptr(), b, n, num_classes, preds.element_size(), out.data_ptr(),
            device.index, current_stream_handle(device))
        check_launch(_OP, err)
        note_kernel_dispatch(_OP, "cuda")
    return out


def confmat_counts_stacked(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """Counts of ``(N,)`` label pairs, or of each row of a ``(B, N)`` stack,
    on the inputs' device. Inside ``torch.func.vmap`` the vmap rule
    (:func:`~metrics_tpu_torch.kernels._common.vmap_stack`) takes the whole
    batch, the axes of nested vmaps flattened into one, to one launch of
    :func:`confmat_counts_batched_cuda`."""
    if _is_batched(preds, target):
        return vmap_stack(confmat_counts_stacked, (preds, target), num_classes)
    wrapper = confmat_counts_cuda if preds.ndim == 1 else confmat_counts_batched_cuda
    return wrapper(preds.contiguous(), target.contiguous(), num_classes, device=preds.device)
