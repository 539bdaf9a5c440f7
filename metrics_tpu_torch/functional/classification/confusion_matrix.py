"""Confusion matrix.

Counterpart of ``metrics_tpu/functional/classification/confusion_matrix.py``.
Multiclass pairs are always counted by the CUDA kernel
:func:`~metrics_tpu_torch.kernels.confusion_matrix.confmat_counts_cuda` (the
JAX package contracts its already-built one-hots on the TPU's matrix unit
for C <= 128 instead; the counts are the same integers). The multilabel
per-class 2x2 case stays four boolean-mask sums.
"""
from typing import Optional

import torch

from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_cuda
from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities.data import Tensor
from metrics_tpu_torch.utilities.enums import DataType
from metrics_tpu_torch.utilities.prints import rank_zero_warn


def _confusion_matrix_update(
    preds: Tensor, target: Tensor, num_classes: int, threshold: float = 0.5, multilabel: bool = False
) -> Tensor:
    preds, target, mode = _input_format_classification(preds, target, threshold)
    if mode not in (DataType.BINARY, DataType.MULTILABEL):
        preds = torch.argmax(preds, dim=1)
        target = torch.argmax(target, dim=1)

    if multilabel:
        # per-class 2x2 tables [[tn, fp], [fn, tp]] via four mask-sums
        p = preds.bool()
        t = target.bool()
        tn = torch.sum(~t & ~p, dim=0)
        fp = torch.sum(~t & p, dim=0)
        fn = torch.sum(t & ~p, dim=0)
        tp = torch.sum(t & p, dim=0)
        confmat = torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)
        return confmat.to(torch.int32)

    # the kernel drops out-of-bounds pairs; fail loudly on the host instead
    # (one transfer for both maxima)
    if preds.numel():
        hi = int(torch.stack([preds.amax(), target.amax()]).amax().item())
        if hi >= num_classes:
            raise ValueError(f"Detected class label {hi} but `num_classes={num_classes}`")
    return confmat_counts_cuda(
        preds.reshape(-1).contiguous(), target.reshape(-1).contiguous(), num_classes, device=preds.device
    )


def _confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.float()
        if normalize == "true":
            cm = confmat / torch.sum(confmat, dim=1, keepdim=True)
        elif normalize == "pred":
            cm = confmat / torch.sum(confmat, dim=0, keepdim=True)
        else:  # "all"
            cm = confmat / torch.sum(confmat)
        nan_mask = torch.isnan(cm)
        cm = torch.where(nan_mask, 0.0, cm)
        num_nan = int(torch.sum(nan_mask).item())
        if num_nan:
            rank_zero_warn(f"{num_nan} nan values found in confusion matrix have been replaced with zeros.")
        return cm
    return confmat


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> Tensor:
    """``(C, C)`` confusion matrix (or ``(C, 2, 2)`` per-label tables when
    ``multilabel=True``), optionally normalized over true/pred/all."""
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold, multilabel)
    return _confusion_matrix_compute(confmat, normalize)
