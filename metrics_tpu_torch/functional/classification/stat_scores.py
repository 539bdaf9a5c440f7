"""True/false positive/negative counting — the shared classification engine.

Counterpart of ``metrics_tpu/functional/classification/stat_scores.py``:
the masked sums of ``_stat_scores``, the update/compute split, and the
weighted reduction ``_reduce_stat_scores``. The per-class counts of 2-D
canonical inputs (``reduce="macro"``) go through the CUDA kernel
(:func:`~metrics_tpu_torch.kernels.stat_scores.stat_scores_counts_cuda`) at
the seam where the JAX package consults its Pallas kernel
(``stat_scores.py:46-55``).

Inside ``torch.func.vmap`` the seam calls
:func:`~metrics_tpu_torch.kernels.stat_scores.stat_scores_counts_stacked`,
whose vmap rule launches the kernel once over the whole stack of per-sample
``(N, C)`` inputs, as the JAX package's ``pallas_call`` batches over a
leading grid axis there: a bootstrap's children, and the keyed path's rows,
each a length-1 batch (one launch for an update's ``(R, 1, C)`` stack). The
keyed path's batched-rows form counts the same stack without the vmap
(:func:`_stat_scores_count` with ``rows``).
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.kernels.stat_scores import stat_scores_counts_stacked
from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities.data import Tensor
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod


def _del_column(data: Tensor, index: int) -> Tensor:
    """Drop column ``index`` from a ``(N, C[, X])`` tensor."""
    return torch.cat([data[:, :index], data[:, (index + 1):]], dim=1)


def _set_class(x: Tensor, index: int, value: float) -> Tensor:
    """``x`` with entry ``index`` of its last axis set to ``value`` (out of place)."""
    return x.index_fill(-1, torch.full((1,), index, dtype=torch.int64, device=x.device), value)


def _stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: str = "micro",
    rows: bool = False,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Count tp/fp/tn/fn over canonical binary ``(N, C)`` or ``(N, C, X)`` inputs.

    Output shapes: micro -> scalar / ``(N,)``; macro -> ``(C,)`` / ``(N, C)``;
    samples -> ``(N,)`` / ``(N, X)``. Macro counts of 2-D inputs go through
    the B1 kernel, batched over the stack inside ``torch.func.vmap``.

    With ``rows`` (``reduce`` micro or macro) each row of ``(N, C)`` inputs
    is counted as a batch of its own: macro ``(N, C)`` from B1's batched
    entry over the ``(N, 1, C)`` stack, the stack the vmap hands it for
    length-1 rows; micro ``(N,)``, the row sums over classes, every count
    from one reduction of ``p * t``, ``p`` and ``t`` (canonical inputs are 0
    or 1: ``fp = Σp - tp``, ``fn = Σt - tp``, ``tn = C - Σp - fn``), exact in
    int32.
    """
    if rows:
        n, c = preds.shape
        if reduce == "macro":
            return stat_scores_counts_stacked(preds.reshape(n, 1, c), target.reshape(n, 1, c))
        tp, pos, true = torch.stack((preds & target, preds, target)).sum(-1, dtype=torch.int32)
        fn = true - tp
        return tp, pos - tp, c - pos - fn, fn
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = 0 if preds.ndim == 2 else 2
    elif reduce == "samples":
        dim = 1
    else:
        raise ValueError(f"The `reduce` {reduce} is not valid.")

    if reduce == "macro" and preds.ndim == 2:
        return stat_scores_counts_stacked(preds, target)

    true_pred = target == preds
    false_pred = target != preds
    pos_pred = preds == 1
    neg_pred = preds == 0

    tp = torch.sum(true_pred & pos_pred, dim=dim)
    fp = torch.sum(false_pred & pos_pred, dim=dim)
    tn = torch.sum(true_pred & neg_pred, dim=dim)
    fn = torch.sum(false_pred & neg_pred, dim=dim)

    dtype = torch.int32
    return tp.to(dtype), fp.to(dtype), tn.to(dtype), fn.to(dtype)


def _stat_scores_update(
    preds: Tensor,
    target: Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Canonicalize inputs and count stats."""
    preds, target, _ = _input_format_classification(
        preds, target, threshold=threshold, num_classes=num_classes, multiclass=multiclass, top_k=top_k
    )
    return _stat_scores_count(preds, target, reduce, mdmc_reduce, ignore_index)


def _stat_scores_count(
    preds: Tensor,
    target: Tensor,
    reduce: str,
    mdmc_reduce: Optional[str],
    ignore_index: Optional[int],
    rows: bool = False,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Count stats of canonical inputs (the second half of
    :func:`_stat_scores_update`); with ``rows``, of each row of 2-D ones as
    a batch of its own (see :func:`_stat_scores`)."""
    if ignore_index is not None and not 0 <= ignore_index < preds.shape[1]:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes")

    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            # (N, C, X) -> (N*X, C)
            preds = torch.transpose(preds, 1, 2).reshape(-1, preds.shape[1])
            target = torch.transpose(target, 1, 2).reshape(-1, target.shape[1])

    if ignore_index is not None and reduce != "macro":
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce, rows=rows)

    if ignore_index is not None and reduce == "macro":
        # flag the ignored class with -1 so downstream reductions mask it out
        tp, fp, tn, fn = (_set_class(x, ignore_index, -1) for x in (tp, fp, tn, fn))

    return tp, fp, tn, fn


def _stat_scores_compute(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tensor:
    """Pack ``[tp, fp, tn, fn, support]`` along a trailing axis, -1 kept as -1."""
    outputs = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return torch.where(outputs < 0, -1, outputs)


def _reduce_stat_scores(
    numerator: Tensor,
    denominator: Tensor,
    weights: Optional[Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    """Weighted ``numerator/denominator`` reduction shared by the stat-scores family.

    denominator==0 -> the ``zero_division`` score; denominator<0 -> class
    ignored (weight zeroed, or NaN when ``average`` is none); ``samplewise``
    averages over the sample axis first.
    """
    numerator = numerator.float()
    denominator = denominator.float()
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.float()

    numerator = torch.where(zero_div_mask, float(zero_division), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, 1.0, denominator)
    weights = torch.where(ignore_mask, 0.0, weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    # all-classes-ignored under 'weighted' -> 0/0; map NaN to zero_division
    scores = torch.where(torch.isnan(scores), float(zero_division), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE and scores.ndim > 0:
        scores = torch.mean(scores, dim=0)
        ignore_mask = torch.sum(ignore_mask, dim=0).bool()

    if average in (AverageMethod.NONE, None):
        scores = torch.where(ignore_mask, float("nan"), scores)
    else:
        scores = torch.sum(scores)

    return scores


def _check_average_arg(
    average: Optional[str],
    mdmc_average: Optional[str],
    num_classes: Optional[int],
    ignore_index: Optional[int],
) -> None:
    """Shared kwarg validation for the stat-scores metric family."""
    allowed_average = ["micro", "macro", "weighted", "samples", "none", None]
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

    allowed_mdmc_average = [None, "samplewise", "global"]
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")

    if average in ["macro", "weighted", "none", None] and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")

    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Compute ``[tp, fp, tn, fn, support]`` for classification inputs.

    ``reduce`` ∈ micro/macro/samples selects the counting granularity;
    ``mdmc_reduce`` ∈ global/samplewise controls how the extra dims of
    multi-dim multi-class inputs fold in.
    """
    if reduce not in ["micro", "macro", "samples"]:
        raise ValueError(f"The `reduce` {reduce} is not valid.")

    if mdmc_reduce not in [None, "samplewise", "global"]:
        raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")

    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")

    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    tp, fp, tn, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        top_k=top_k,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _stat_scores_compute(tp, fp, tn, fn)
