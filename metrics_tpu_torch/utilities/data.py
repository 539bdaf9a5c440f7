"""Tensor and device helpers shared by the metrics.

Counterpart of ``metrics_tpu/utilities/data.py``, limited to what the
classification path uses, plus the device rule of the port
(:func:`resolve_device`, :func:`check_device`). The one-hot and top-k masks are built by
comparison with an ``arange`` along the class axis, so a label outside
``[0, C)`` gives an all-zero row (as ``jax.nn.one_hot`` does) instead of a
device-side assert.

:func:`_is_batched` is the counterpart of JAX's ``_is_traced``: it is true
for a tensor inside ``torch.func.vmap`` (the per-row update of the keyed
path), where a value cannot be read to the host.
"""
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _is_batched(*tensors: Any) -> bool:
    """True if any of ``tensors`` is a batched tensor of ``torch.func.vmap``
    (whose values cannot be read to the host with ``.item()``/``.tolist()``)."""
    return any(isinstance(t, Tensor) and torch._C._functorch.is_batchedtensor(t) for t in tensors)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``, with a CUDA device's index filled in.

    Raises when a CUDA device is asked for and none is present: the port
    never carries on on the CPU unless the caller asks for the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r} was asked for, but no CUDA device is present;"
                               " pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_device(device: torch.device, *tensors: Any) -> None:
    """Raise if any tensor among ``tensors`` lies on another device than ``device``."""
    for tensor in tensors:
        if isinstance(tensor, Tensor) and tensor.device != device:
            raise ValueError(f"expected a tensor on {device}, got one on {tensor.device}")


def _flatten(x: Sequence[Sequence[Any]]) -> List[Any]:
    return [item for sub in x for item in sub]


def dim_zero_cat(x: Union[Tensor, List[Tensor], Tuple[Tensor, ...]]) -> Tensor:
    """Concatenate a (list of) tensor(s) along the leading axis.

    Scalars are promoted to shape ``(1,)`` so appended 0-d states concatenate.
    """
    items = list(x) if isinstance(x, (list, tuple)) else [x]
    if not items:
        raise ValueError("No samples to concatenate")
    return torch.cat([torch.atleast_1d(it) for it in items], dim=0)


def dim_zero_sum(x: Tensor) -> Tensor:
    return torch.sum(x, dim=0)


def dim_zero_mean(x: Tensor) -> Tensor:
    return torch.mean(x if x.is_floating_point() else x.float(), dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.amax(x, dim=0)


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.amin(x, dim=0)


def _class_axis(num_classes: int, ndim: int, device: torch.device) -> Tensor:
    """``arange(C)`` shaped ``(1, C, 1, ...)`` for a tensor of ``ndim`` dims."""
    return torch.arange(num_classes, device=device).view(1, num_classes, *([1] * (ndim - 2)))


def to_onehot(label_tensor: Tensor, num_classes: Optional[int] = None) -> Tensor:
    """Dense labels ``[N, d1, ...]`` -> one-hot ``[N, C, d1, ...]`` in the labels' dtype."""
    if label_tensor.dtype == torch.bool:
        label_tensor = label_tensor.to(torch.int32)
    if num_classes is None:
        if _is_batched(label_tensor):
            raise ValueError("`num_classes` must be given explicitly when one-hot encoding inside a vmapped program.")
        num_classes = int(label_tensor.max().item()) + 1
    classes = _class_axis(num_classes, label_tensor.ndim + 1, label_tensor.device)
    return (label_tensor.unsqueeze(1) == classes).to(label_tensor.dtype)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """Binarize by marking the top-k entries along ``dim`` with 1 (int32 output)."""
    if topk == 1:
        top_idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
        moved = top_idx.movedim(dim, 1)
        classes = _class_axis(prob_tensor.shape[dim], moved.ndim, prob_tensor.device)
        return (moved == classes).movedim(1, dim).to(torch.int32)
    top_idx = torch.topk(prob_tensor, topk, dim=dim).indices
    return torch.zeros(prob_tensor.shape, dtype=torch.int32, device=prob_tensor.device).scatter_(dim, top_idx, 1)


def to_categorical(x: Tensor, argmax_dim: int = 1) -> Tensor:
    """Probabilities ``[N, C, d2, ...]`` -> dense labels ``[N, d2, ...]``."""
    return torch.argmax(x, dim=argmax_dim)


def get_num_classes(preds: Tensor, target: Tensor, num_classes: Optional[int] = None) -> int:
    """Infer the number of classes from data values (reads them on the host).

    Inside a vmapped program no value can be read: ``num_classes`` is then
    returned as given, and raises when it is not."""
    if _is_batched(preds, target):
        if num_classes is None:
            raise ValueError("`num_classes` must be given explicitly inside a vmapped program.")
        return num_classes
    num_target_classes = int(target.max().item()) + 1
    num_pred_classes = int(preds.max().item()) + 1
    num_all_classes = max(num_target_classes, num_pred_classes)
    if num_classes is None:
        return num_all_classes
    if num_classes != num_all_classes:
        rank_zero_warn(
            f"You have set {num_classes} number of classes which is"
            f" different from predicted ({num_pred_classes}) and"
            f" target ({num_target_classes}) number of classes",
            RuntimeWarning,
        )
    return num_classes


def apply_to_collection(
    data: Any,
    dtype: Union[type, tuple],
    function: Callable,
    *args: Any,
    wrong_dtype: Optional[Union[type, tuple]] = None,
    **kwargs: Any,
) -> Any:
    """Recursively apply ``function`` to every element of type ``dtype`` in a
    collection (dict / namedtuple / sequence), preserving the container types."""
    elem_type = type(data)

    if isinstance(data, dtype) and (wrong_dtype is None or not isinstance(data, wrong_dtype)):
        return function(data, *args, **kwargs)

    if isinstance(data, Mapping):
        return elem_type(
            {k: apply_to_collection(v, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for k, v in data.items()}
        )
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return elem_type(
            *(apply_to_collection(d, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for d in data)
        )
    if isinstance(data, Sequence) and not isinstance(data, str):
        return elem_type(
            [apply_to_collection(d, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for d in data]
        )
    return data
