"""Input canonicalization and validation for classification metrics.

Counterpart of ``metrics_tpu/utilities/checks.py`` (``_check_classification_inputs``
and ``_input_format_classification``, ``checks.py:182-304``), with the same
case inference, override matrix and error messages.

The value checks (non-negative targets, label ranges, binary targets for
float predictions) need data values on the host. Each tensor's
``(min, max)`` is read there once per call, in one transfer
(:func:`_host_range`), and every check and the class-count inference read
that pair: canonicalizing a batch of float predictions costs one
device-to-host read of the targets, where reading each value separately
would cost one synchronisation per check.

Inside ``torch.func.vmap`` (the keyed path's per-row update, see
:func:`~metrics_tpu_torch.utilities.stacked.row_states`) no value can be
read: the ranges are then ``None`` and every value check is skipped, where
the JAX package skips them under ``_is_traced`` (``checks.py:40,72,141,205``).
The keyed path runs the same checks once on the whole batch before the
vmap. Label predictions without ``num_classes`` raise there, as they do
under a JAX trace (``checks.py:280-284``).
"""
import math
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utilities.data import Tensor, _is_batched, select_topk, to_onehot
from metrics_tpu_torch.utilities.enums import DataType

Number = Union[int, float]
#: ``(min, max)`` of a tensor on the host, or ``None`` for an empty tensor
Range = Optional[Tuple[Number, Number]]


def _host_range(x: Tensor) -> Range:
    """``(min, max)`` of ``x`` read to the host in one transfer."""
    if x.numel() == 0:
        return None
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    elif x.dtype in (torch.float16, torch.bfloat16):
        x = x.float()
    lo, hi = torch.aminmax(x)
    return tuple(torch.stack([lo, hi]).tolist())


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
) -> Tuple[DataType, Range, Range]:
    """Full input validation: the inferred case, plus the host ranges of
    ``target`` and of integer ``preds`` (``None`` for float ``preds``, and
    for both inside a vmapped program, where the value checks are skipped)."""
    batched = _is_batched(preds, target)
    t_range = None if batched else _host_range(target)
    p_range = None if batched or preds.is_floating_point() else _host_range(preds)

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
) -> Tuple[Tensor, Tensor, DataType]:
    """Canonicalize every classification input into binary int tensors.

    Output is always ``(N, C)`` or ``(N, C, X)`` int32 plus the inferred case:

    * binary / multi-label: probabilities thresholded (or top-k for
      multi-label); ``multiclass=True`` expands to a 2-class one-hot.
    * (multi-dim) multi-class: targets one-hot; float preds top-k one-hot;
      ``multiclass=False`` squashes 2-class data down to the positive column.
    * all extra dims are flattened into ``X``; size-1 dims (except N) squeezed.
    """
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)

    preds, target = _input_squeeze(preds, target)

    # half-precision inputs are canonicalized through f32 (outputs are int)
    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.float()

    case, t_range, p_range = _check_inputs_with_ranges(
        preds, target, num_classes=num_classes, multiclass=multiclass, top_k=top_k
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
                if _is_batched(preds, target):
                    raise ValueError(
                        "`num_classes` must be given explicitly when canonicalizing label "
                        "predictions inside a vmapped (per-row) program."
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
