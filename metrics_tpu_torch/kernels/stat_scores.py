"""Fused tp/fp/tn/fn counting: the stat-scores family's inner loop.

Counterpart of ``metrics_tpu/kernels/stat_scores.py``. The per-class
confusion counts behind Precision/Recall/F1/StatScores reduce canonical
binary ``(N, C)`` inputs with four masked sums. Two formulations:

* :func:`stat_scores_counts_torch`, the plain version: four boolean masks,
  four column sums (the ``stat_scores_counts_xla`` of the JAX package).
* :func:`stat_scores_counts_cuda`, the wrapper of the hand-written kernel
  ``csrc/stat_scores.cu`` (which replaces the Pallas ``_stat_scores_kernel``):
  one pass over both inputs, one thread per class column, exact int32
  counts. It takes a CUDA tensor to the kernel and a CPU tensor to the plain
  version, and a ``(B, N, C)`` stack as well as one ``(N, C)`` input: the
  kernel's batched form counts every slice in one launch, with one thread
  per (slice, column) where the slices are short (the keyed path's
  ``(R, 1, C)`` rows).
* :func:`stat_scores_counts_stacked`, the seam's call inside
  ``torch.func.vmap``: its vmap rule (``_common.vmap_stack``) hands the
  whole stack to the wrapper in one launch, as ``pallas_call``'s batching
  rule runs the Pallas kernel over a leading grid axis.
"""
import ctypes
from typing import Tuple, Union

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

_OP = "stat_scores_counts"
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
)
_BATCHED_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p,
)


def stat_scores_counts_torch(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Four ``(C,)`` int32 count vectors (tp, fp, tn, fn) over canonical
    binary ``(N, C)`` inputs (the ``reduce="macro"`` sums of ``_stat_scores``),
    or four ``(B, C)`` ones, a row per slice of a ``(B, N, C)`` stack."""
    true_pred = target == preds
    false_pred = target != preds
    pos_pred = preds == 1
    neg_pred = preds == 0
    tp = torch.sum(true_pred & pos_pred, dim=-2)
    fp = torch.sum(false_pred & pos_pred, dim=-2)
    tn = torch.sum(true_pred & neg_pred, dim=-2)
    fn = torch.sum(false_pred & neg_pred, dim=-2)
    return tp.to(torch.int32), fp.to(torch.int32), tn.to(torch.int32), fn.to(torch.int32)


def stat_scores_counts_cuda(
    preds: Tensor, target: Tensor, device: Union[str, torch.device] = "cuda"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-class tp/fp/tn/fn of canonical binary ``(N, C)`` int32 inputs lying
    on ``device``, or of each slice of a ``(B, N, C)`` stack (four ``(B, C)``
    outputs).

    On a CUDA device the kernel counts, in one launch either way; on the CPU
    the plain version does. Raises on inputs the kernel does not take.
    """
    device = kernel_device(device)
    check_device(device, preds, target)
    if preds.ndim not in (2, 3) or preds.shape != target.shape:
        raise ValueError(f"expected preds and target of one shape (N, C) or (B, N, C), got {tuple(preds.shape)} and"
                         f" {tuple(target.shape)}")
    if device.type == "cpu":
        note_kernel_dispatch(_OP, "torch")
        return stat_scores_counts_torch(preds, target)
    if device.type != "cuda":
        raise ValueError(f"{_OP} runs on a CUDA or the CPU device, not on {device}")
    if preds.dtype != torch.int32 or target.dtype != torch.int32:
        raise TypeError(f"{_OP} takes int32 inputs, got {preds.dtype} and {target.dtype}")
    if not (preds.is_contiguous() and target.is_contiguous()):
        raise ValueError(f"{_OP} takes contiguous inputs")
    require_capability(device)
    if preds.ndim == 3:
        return _batched_counts_cuda(preds, target, device)
    return _counts_cuda(preds, target, device)


def _counts_cuda(preds: Tensor, target: Tensor, device: torch.device) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One zero fill and one call into the C library, which makes ``device``
    current for its launch on that device's current stream."""
    n, c = preds.shape
    out = torch.zeros((4, c), dtype=torch.int32, device=device)
    if n and c:
        err = kernel_function("stat_scores_counts_launch", _ARGTYPES)(
            preds.data_ptr(), target.data_ptr(), n, c, out.data_ptr(), device.index, current_stream_handle(device))
        check_launch(_OP, err)
        note_kernel_dispatch(_OP, "cuda")
    return out[0], out[1], out[2], out[3]


def _batched_counts_cuda(preds: Tensor, target: Tensor,
                         device: torch.device) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The batched form of :func:`_counts_cuda`: one launch counts every
    ``(N, C)`` slice of the stack into the ``(4, B, C)`` output, which the C
    entry fills itself (short slices store every cell, long ones are zeroed
    on the stream first), so it is allocated without a fill."""
    b, n, c = preds.shape
    out = torch.empty((4, b, c), dtype=torch.int32, device=device)
    if b and c:
        err = kernel_function("stat_scores_counts_batched_launch", _BATCHED_ARGTYPES)(
            preds.data_ptr(), target.data_ptr(), b, n, c, out.data_ptr(), device.index, current_stream_handle(device))
        check_launch(_OP, err)
        note_kernel_dispatch(_OP, "cuda")
    return out[0], out[1], out[2], out[3]


def stat_scores_counts_stacked(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-class counts of ``(N, C)`` inputs, or of each ``(N, C)`` slice of a
    ``(B, N, C)`` stack, on the inputs' device. Inside ``torch.func.vmap``
    the vmap rule (:func:`~metrics_tpu_torch.kernels._common.vmap_stack`)
    takes the whole batch, the axes of nested vmaps flattened into one, to
    one launch of :func:`stat_scores_counts_cuda`."""
    if _is_batched(preds, target):
        return vmap_stack(stat_scores_counts_stacked, (preds, target))
    return stat_scores_counts_cuda(preds.contiguous(), target.contiguous(), device=preds.device)
