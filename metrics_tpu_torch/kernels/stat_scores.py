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
  version.
"""
import ctypes
from typing import Tuple, Union

import torch

from metrics_tpu_torch.kernels._common import (
    check_launch,
    current_stream_handle,
    kernel_function,
    note_kernel_dispatch,
    require_capability,
)
from metrics_tpu_torch.utilities.data import Tensor, check_device, resolve_device

_OP = "stat_scores_counts"
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p)


def stat_scores_counts_torch(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Four ``(C,)`` int32 count vectors (tp, fp, tn, fn) over canonical
    binary ``(N, C)`` inputs (the ``reduce="macro"`` sums of ``_stat_scores``)."""
    true_pred = target == preds
    false_pred = target != preds
    pos_pred = preds == 1
    neg_pred = preds == 0
    tp = torch.sum(true_pred & pos_pred, dim=0)
    fp = torch.sum(false_pred & pos_pred, dim=0)
    tn = torch.sum(true_pred & neg_pred, dim=0)
    fn = torch.sum(false_pred & neg_pred, dim=0)
    return tp.to(torch.int32), fp.to(torch.int32), tn.to(torch.int32), fn.to(torch.int32)


def stat_scores_counts_cuda(
    preds: Tensor, target: Tensor, device: Union[str, torch.device] = "cuda"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-class tp/fp/tn/fn of canonical binary ``(N, C)`` int32 inputs lying on ``device``.

    On a CUDA device the kernel counts; on the CPU the plain version does.
    Raises on inputs the kernel does not take.
    """
    device = resolve_device(device)
    check_device(device, preds, target)
    if preds.ndim != 2 or preds.shape != target.shape:
        raise ValueError(f"expected preds and target of one shape (N, C), got {tuple(preds.shape)} and"
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

    n, c = preds.shape
    out = torch.zeros((4, c), dtype=torch.int32, device=device)
    if n and c:
        launch = kernel_function("stat_scores_counts_launch", _ARGTYPES)
        with torch.cuda.device(device):
            stream = current_stream_handle(device)
            check_launch(_OP, launch(preds.data_ptr(), target.data_ptr(), n, c, out.data_ptr(), stream))
        note_kernel_dispatch(_OP, "cuda")
    return out[0], out[1], out[2], out[3]
