"""Input canonicalization and validation for classification and retrieval metrics.

Counterpart of ``metrics_tpu/utilities/checks.py`` (``_check_classification_inputs``
and ``_input_format_classification``, ``checks.py:182-304``; the retrieval
checks ``_check_retrieval_functional_inputs`` and ``_check_retrieval_inputs``,
``checks.py:334-395``), with the same case inference, override matrix and
error messages. The retrieval checks read the targets' range to the host
once, in one transfer, and skip that read where no value can be read.

The value checks (non-negative targets, label ranges, binary targets for
float predictions) need data values on the host. Each tensor's
``(min, max)`` is read there once per call, in one transfer
(:func:`_host_range`), and every check and the class-count inference read
that pair: canonicalizing a batch of float predictions costs one
device-to-host read of the targets, where reading each value separately
would cost one synchronisation per check.

Inside ``torch.func.vmap`` (the keyed path's per-row update, see
:func:`~metrics_tpu_torch.utilities.stacked.row_states`) and inside a
compiled dispatch's program (``jit_forward``, ``update_many``, captured
into a CUDA graph on the card) no value can be read
(:func:`~metrics_tpu_torch.utilities.data._is_traced`): the ranges are then
``None`` and :func:`_host_range` is never called, so every value check and
the class-count inference skip, where the JAX package skips them under
``_is_traced`` (``checks.py:40,72,141,205``). The eager keyed path runs the
same checks once on the whole batch before its per-row states. Label
predictions without ``num_classes`` raise in the vmap, as they do under a
JAX trace (``checks.py:280-284``). The keyed path's batched-rows form
canonicalizes the whole batch once with ``read_values=False``, the same
skips without a vmap, where :func:`_rows_format_alike` finds that equal to
each row's own canonical form.
"""
import math
from typing import Any, Optional, Tuple, Union

import torch

from metrics_tpu_torch.observability.tracing import _NULL_SPAN, TRACER
from metrics_tpu_torch.utilities.data import Tensor, _is_traced, select_topk, to_host, to_onehot
from metrics_tpu_torch.utilities.enums import DataType

Number = Union[int, float]
#: ``(min, max)`` of a tensor on the host, or ``None`` for an empty tensor
Range = Optional[Tuple[Number, Number]]


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if predictions and targets differ in shape."""
    if preds.shape != target.shape:
        raise RuntimeError("Predictions and targets are expected to have the same shape")


def _host_range(x: Tensor) -> Range:
    """``(min, max)`` of ``x`` read to the host in one transfer."""
    if x.numel() == 0:
        return None
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    elif x.dtype in (torch.float16, torch.bfloat16):
        x = x.float()
    lo, hi = torch.aminmax(x)
    return tuple(to_host(torch.stack([lo, hi])))


def _basic_input_validation(
    preds: Tensor, target: Tensor, multiclass: Optional[bool], t_range: Range, p_range: Range
) -> None:
    """Value/dtype checks that need no case information."""
    if target.is_floating_point():
        raise ValueError("The `target` has to be an integer tensor.")

    if t_range is not None and t_range[0] < 0:
        raise ValueError("The `target` has to be a non-negative tensor.")
    if p_range is not None and p_range[0] < 0:
        raise ValueError("If `preds` are integers, they have to be non-negative.")
    if multiclass is False and t_range is not None and t_range[1] > 1:
        raise ValueError("If you set `multiclass=False`, then `target` should not exceed 1.")
    if multiclass is False and p_range is not None and p_range[1] > 1:
        raise ValueError("If you set `multiclass=False` and `preds` are integers, then `preds` should not exceed 1.")

    if not preds.shape[0] == target.shape[0]:
        raise ValueError("The `preds` and `target` should have the same first dimension.")


def _check_shape_and_type_consistency(preds: Tensor, target: Tensor, t_range: Range) -> Tuple[DataType, int]:
    """Infer the input case from shapes and dtypes.

    Returns the case and the implied number of classes (C dim for multi-class,
    flattened extra dims for multi-label).
    """
    preds_float = preds.is_floating_point()

    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        if preds_float and t_range is not None and t_range[1] > 1:
            raise ValueError(
                "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary."
            )
        if preds.ndim == 1:
            case = DataType.BINARY if preds_float else DataType.MULTICLASS
        else:
            case = DataType.MULTILABEL if preds_float else DataType.MULTIDIM_MULTICLASS
        implied_classes = math.prod(preds.shape[1:]) if preds.ndim > 1 else 1

    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        implied_classes = preds.shape[1]
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )

    return case, implied_classes


def _check_num_classes_binary(num_classes: int, multiclass: Optional[bool]) -> None:
    """Consistency of ``num_classes`` with binary data."""
    if num_classes > 2:
        raise ValueError("Your data is binary, but `num_classes` is larger than 2.")
    if num_classes == 2 and not multiclass:
        raise ValueError(
            "Your data is binary and `num_classes=2`, but `multiclass` is not True."
            " Set it to True if you want to transform binary data to multi-class format."
        )
    if num_classes == 1 and multiclass:
        raise ValueError(
            "You have binary data and have set `multiclass=True`, but `num_classes` is 1."
            " Either set `multiclass=None`(default) or set `num_classes=2`"
            " to transform binary data to multi-class format."
        )


def _check_num_classes_mc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multiclass: Optional[bool],
    implied_classes: int,
    t_range: Range,
    p_range: Range,
) -> None:
    """Consistency of ``num_classes`` with (multi-dim) multi-class data."""
    if num_classes == 1 and multiclass is not False:
        raise ValueError(
            "You have set `num_classes=1`, but predictions are integers."
            " If you want to convert (multi-dimensional) multi-class data with 2 classes"
            " to binary/multi-label, set `multiclass=False`."
        )
    if num_classes > 1:
        if multiclass is False and implied_classes != num_classes:
            raise ValueError(
                "You have set `multiclass=False`, but the implied number of classes "
                " (from shape of inputs) does not match `num_classes`. If you are trying to"
                " transform multi-dim multi-class data with 2 classes to multi-label, `num_classes`"
                " should be either None or the product of the size of extra dimensions (...)."
                " See Input Types in Metrics documentation."
            )
        if t_range is not None and num_classes <= t_range[1]:
            raise ValueError("The highest label in `target` should be smaller than `num_classes`.")
        if p_range is not None and num_classes <= p_range[1]:
            raise ValueError("The highest label in `preds` should be smaller than `num_classes`.")
        if preds.shape != target.shape and num_classes != implied_classes:
            raise ValueError("The size of C dimension of `preds` does not match `num_classes`.")


def _check_num_classes_ml(num_classes: int, multiclass: Optional[bool], implied_classes: int) -> None:
    """Consistency of ``num_classes`` with multi-label data."""
    if multiclass and num_classes != 2:
        raise ValueError(
            "Your have set `multiclass=True`, but `num_classes` is not equal to 2."
            " If you are trying to transform multi-label data to 2 class multi-dimensional"
            " multi-class, you should set `num_classes` to either 2 or None."
        )
    if not multiclass and num_classes != implied_classes:
        raise ValueError("The implied number of classes (from shape of inputs) does not match num_classes.")


def _check_top_k(
    top_k: int, case: DataType, implied_classes: int, multiclass: Optional[bool], preds_float: bool
) -> None:
    if case == DataType.BINARY:
        raise ValueError("You can not use `top_k` parameter with binary data.")
    if not isinstance(top_k, int) or top_k <= 0:
        raise ValueError("The `top_k` has to be an integer larger than 0.")
    if not preds_float:
        raise ValueError("You have set `top_k`, but you do not have probability predictions.")
    if multiclass is False:
        raise ValueError("If you set `multiclass=False`, you can not set `top_k`.")
    if case == DataType.MULTILABEL and multiclass:
        raise ValueError(
            "If you want to transform multi-label data to 2 class multi-dimensional"
            "multi-class data using `multiclass=True`, you can not use `top_k`."
        )
    if top_k >= implied_classes:
        raise ValueError("The `top_k` has to be strictly smaller than the `C` dimension of `preds`.")


def _check_inputs_with_ranges(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    read_values: bool = True,
) -> Tuple[DataType, Range, Range]:
    """Full input validation: the inferred case, plus the host ranges of
    ``target`` and of integer ``preds`` (``None`` for float ``preds``, and
    for both inside a traced program or without ``read_values``, where the
    value checks are skipped)."""
    traced = not read_values or _is_traced(preds, target)
    # the value and shape checks: the ``checks`` phase of an open host request
    with (_NULL_SPAN if traced else TRACER.phase("checks")):
        t_range = None if traced else _host_range(target)
        p_range = None if traced or preds.is_floating_point() else _host_range(preds)

        _basic_input_validation(preds, target, multiclass, t_range, p_range)

        case, implied_classes = _check_shape_and_type_consistency(preds, target, t_range)

        if preds.shape != target.shape:
            if multiclass is False and implied_classes != 2:
                raise ValueError(
                    "You have set `multiclass=False`, but have more than 2 classes in your data,"
                    " based on the C dimension of `preds`."
                )
            if t_range is not None and t_range[1] >= implied_classes:
                raise ValueError(
                    "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."
                )

        if num_classes:
            if case == DataType.BINARY:
                _check_num_classes_binary(num_classes, multiclass)
            elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
                _check_num_classes_mc(preds, target, num_classes, multiclass, implied_classes, t_range, p_range)
            elif case == DataType.MULTILABEL:
                _check_num_classes_ml(num_classes, multiclass, implied_classes)

        if top_k is not None:
            _check_top_k(top_k, case, implied_classes, multiclass, preds.is_floating_point())

        return case, t_range, p_range


def _check_classification_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
) -> DataType:
    """Full input validation; returns the inferred case."""
    return _check_inputs_with_ranges(preds, target, num_classes, multiclass, top_k)[0]


def _input_squeeze(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Drop all size-1 dimensions except the leading sample dimension."""
    if preds.shape[0] == 1:
        preds = torch.squeeze(preds).unsqueeze(0)
        target = torch.squeeze(target).unsqueeze(0)
    else:
        preds, target = torch.squeeze(preds), torch.squeeze(target)
    return preds, target


def _input_format_classification(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    read_values: bool = True,
) -> Tuple[Tensor, Tensor, DataType]:
    """Canonicalize every classification input into binary int tensors.

    Output is always ``(N, C)`` or ``(N, C, X)`` int32 plus the inferred case:

    * binary / multi-label: probabilities thresholded (or top-k for
      multi-label); ``multiclass=True`` expands to a 2-class one-hot.
    * (multi-dim) multi-class: targets one-hot; float preds top-k one-hot;
      ``multiclass=False`` squashes 2-class data down to the positive column.
    * all extra dims are flattened into ``X``; size-1 dims (except N) squeezed.

    Without ``read_values`` no value is read, as inside a traced program: the
    value checks and the class-count inference skip (the keyed path's
    batched rows, :func:`_rows_format_alike`).
    """
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)

    preds, target = _input_squeeze(preds, target)

    # half-precision inputs are canonicalized through f32 (outputs are int)
    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.float()

    case, t_range, p_range = _check_inputs_with_ranges(
        preds, target, num_classes=num_classes, multiclass=multiclass, top_k=top_k, read_values=read_values
    )

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = (preds >= threshold).to(torch.int32)
        num_classes = num_classes if not multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or multiclass:
        if preds.is_floating_point():
            num_classes = preds.shape[1]
            preds = select_topk(preds, top_k or 1)
        else:
            if not num_classes:
                if not read_values or _is_traced(preds, target):
                    raise ValueError(
                        "`num_classes` must be given explicitly when canonicalizing label "
                        "predictions inside a traced (vmapped or compiled) program."
                    )
                p_hi = (p_range or (0, 0))[1]
                num_classes = int(max(p_hi, (t_range or (0, 0))[1])) + 1
            preds = to_onehot(preds, max(2, num_classes))

        target = to_onehot(target, max(2, int(num_classes) if num_classes else 2))

        if multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and multiclass is not False) or multiclass:
        target = target.reshape(target.shape[0], target.shape[1], -1)
        preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
    else:
        target = target.reshape(target.shape[0], -1)
        preds = preds.reshape(preds.shape[0], -1)

    # drop the trailing singleton the reshapes above create for flat MC/binary data
    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = torch.squeeze(preds, -1), torch.squeeze(target, -1)

    return preds.to(torch.int32), target.to(torch.int32), case


def _rows_format_alike(preds: Any, target: Any, num_classes: Optional[int], multiclass: Optional[bool]) -> bool:
    """Whether :func:`_input_format_classification` of a whole ``(B, ...)``
    batch, without reading a value, equals row by row that of each row alone
    as a length-1 batch, which is what the keyed path's vmap gives
    (:func:`~metrics_tpu_torch.utilities.stacked.row_states`), and is 2-D.

    That holds for tensors of B >= 1 rows with no other axis of size 1 (a
    length-1 row's squeeze would drop it) and no ``multiclass`` override, in
    the cases whose canonical form is ``(B, C)`` and whose class count needs
    no value: float binary ``(B,)``, multi-label ``(B, L)`` and multi-class
    ``(B, C)`` predictions with ``(B,)`` targets, and ``(B,)`` label
    predictions with ``num_classes``. Every step of the canonicalization is
    then a row-wise op (threshold, top-k, one-hot, reshape)."""
    if not (isinstance(preds, Tensor) and isinstance(target, Tensor)) or multiclass is not None:
        return False
    if preds.ndim not in (1, 2) or preds.shape[0] == 0 or 1 in preds.shape[1:]:
        return False
    if target.ndim != 1 and target.shape != preds.shape:
        return False
    if preds.is_floating_point():
        return True
    return preds.ndim == 1 and bool(num_classes) and (_is_integer(preds) or preds.dtype == torch.bool)


def _is_integer(x: Tensor) -> bool:
    return not (x.dtype.is_floating_point or x.is_complex() or x.dtype == torch.bool)


def _check_retrieval_target_dtype(target: Tensor, allow_non_binary_target: bool) -> bool:
    """Raise unless the targets are booleans or integers (or, for graded
    relevance, floats); returns whether they are booleans or integers."""
    target_is_int = _is_integer(target) or target.dtype == torch.bool
    if not target_is_int and not (allow_non_binary_target and target.is_floating_point()):
        raise ValueError("`target` must be a tensor of booleans or integers")
    return target_is_int


def _retrieval_target(target: Tensor, target_is_int: bool, allow_non_binary_target: bool) -> Tensor:
    """The targets' value check (one host read of their range, skipped where
    no value can be read), then int32, or float32 for graded relevance."""
    if not _is_traced(target):
        lo, hi = _host_range(target)
        if (not allow_non_binary_target and hi > 1) or lo < 0:
            raise ValueError("`target` must contain `binary` values")
    return target.to(torch.int32 if target_is_int else torch.float32).reshape(-1)


def _check_retrieval_functional_inputs(
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Validate and flatten a (preds, target) retrieval pair -> (float32,
    int32), or float32 targets for graded relevance (nDCG)."""
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if preds.ndim == 0 or preds.numel() == 0:
        raise ValueError("`preds` and `target` must be non-empty and non-scalar tensors")
    target_is_int = _check_retrieval_target_dtype(target, allow_non_binary_target)
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    return preds.to(torch.float32).reshape(-1), _retrieval_target(target, target_is_int, allow_non_binary_target)


def _check_retrieval_inputs(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Validate and flatten an (indexes, preds, target) triple -> (int32,
    float32, int32), or float32 targets for graded relevance (nDCG). The
    query ids are cast to int32 as the JAX package casts them, wrapping ids
    outside its range."""
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if indexes.ndim == 0 or indexes.numel() == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")
    if not _is_integer(indexes):
        raise ValueError("`indexes` must be a tensor of long integers")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    target_is_int = _check_retrieval_target_dtype(target, allow_non_binary_target)
    return (
        indexes.to(torch.int32).reshape(-1),
        preds.to(torch.float32).reshape(-1),
        _retrieval_target(target, target_is_int, allow_non_binary_target),
    )
