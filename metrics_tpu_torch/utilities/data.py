"""Tensor and device helpers shared by the metrics.

Counterpart of ``metrics_tpu/utilities/data.py``, limited to what the
classification, regression and retrieval paths use (with ``METRIC_EPS``,
the curves' guard against a zero denominator, :func:`tie_group_bounds`, the
tie groups behind Spearman's fractional ranks, and :func:`get_group_indexes`,
``data.py:172-188``), plus the device rule of the port
(:func:`resolve_device`, :func:`check_device`). The one-hot and top-k masks are built by
comparison with an ``arange`` along the class axis, so a label outside
``[0, C)`` gives an all-zero row (as ``jax.nn.one_hot`` does) instead of a
device-side assert.

:func:`_is_traced` is the counterpart of JAX's ``_is_traced``: it is true
for a tensor inside ``torch.func.vmap`` (the per-row update of the keyed
path, :func:`_is_batched`) and for any tensor while a compiled dispatch
runs its program (:class:`trace_scope`, set by
:class:`~metrics_tpu_torch.utilities.aot.CompiledDispatch`: on the card the
program is captured into a CUDA graph, which no host read may enter). Both
times a value cannot be read to the host, and the value checks skip.

:func:`full_fp32` keeps a block's float32 matmuls and convolutions on the
card out of TF32, whatever the process's precision settings say.

:func:`to_host` is the port's one read of tensor values into Python, so the
tracer can count and time every wait of the host for the card.
"""
import contextlib
import threading
from typing import Any, Callable, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor

METRIC_EPS = 1e-6


def _is_batched(*tensors: Any) -> bool:
    """True if any of ``tensors`` is a batched tensor of ``torch.func.vmap``
    (whose values cannot be read to the host with ``.item()``/``.tolist()``)."""
    return any(isinstance(t, Tensor) and torch._C._functorch.is_batchedtensor(t) for t in tensors)


class _TraceState(threading.local):
    """Per thread: whether a compiled dispatch's program is running
    (``active``), and whether this run records trace telemetry
    (``count_traces``: a capture on the card, the first call of a signature
    on the CPU, as a JAX trace runs once per compile)."""

    active = False
    count_traces = False


_TRACE = _TraceState()


class trace_scope:
    """Context manager marking the block as a compiled program's run on this
    thread (see :func:`_is_traced`); nests, restoring the outer state."""

    __slots__ = ("_count", "_saved")

    def __init__(self, count_traces: bool = False) -> None:
        self._count = bool(count_traces)

    def __enter__(self) -> "trace_scope":
        self._saved = (_TRACE.active, _TRACE.count_traces)
        _TRACE.active, _TRACE.count_traces = True, self._count
        return self

    def __exit__(self, *exc: Any) -> None:
        _TRACE.active, _TRACE.count_traces = self._saved


def _is_traced(*tensors: Any) -> bool:
    """True inside a compiled dispatch's program on this thread, whatever the
    tensors, or if any of ``tensors`` is a ``torch.func.vmap`` batched
    tensor: no value can be read to the host."""
    return _TRACE.active or _is_batched(*tensors)


def _counts_traces() -> bool:
    """True while a compiled dispatch captures (or, on the CPU, runs a
    signature for the first time): the trace counters count then, once per
    pure call, as a JAX trace runs each call once."""
    return _TRACE.active and _TRACE.count_traces


class untraced_repeats:
    """Context manager for the second and later micro-batches of an
    unrolled ``update_many``: a JAX ``lax.scan`` traces its body once,
    however many micro-batches it scans, so their calls count no trace."""

    __slots__ = ("_saved",)

    def __enter__(self) -> "untraced_repeats":
        self._saved = _TRACE.count_traces
        _TRACE.count_traces = False
        return self

    def __exit__(self, *exc: Any) -> None:
        _TRACE.count_traces = self._saved


def to_host(t: Any, numpy: bool = False) -> Any:
    """``t.tolist()``, or with ``numpy`` ``t.cpu().numpy()``: the values of a
    tensor read to the host, the port's one way to do so. Each such read
    waits for the card to finish the work that makes ``t`` and copies it
    back. With the tracer on it is a ``host_read`` span, counted in its
    request (see :meth:`~metrics_tpu_torch.observability.tracing.SpanTracker.span`);
    off, it is the bare read after one flag read. Both read on one line, so
    that a synchronizing call is reported at the same place either way."""
    with (TRACER.span(HOST_READ) if TRACER.enabled else _NULL_SPAN):
        return t.cpu().numpy() if numpy else t.tolist()


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


class _Fp32Blocks:
    """The process-wide TF32 flags' owner while any :func:`full_fp32` block
    is open on any thread: the first block to open saves and clears them,
    the last to close restores them, all under one lock. The flags are
    process-wide, so blocks on the serving flusher or the async sync worker
    would otherwise restore each other's saved values mid-block."""

    lock = threading.Lock()
    depth = 0
    saved: Tuple[bool, bool] = (False, False)


@contextlib.contextmanager
def full_fp32(device: torch.device) -> Iterator[None]:
    """Full float32 (no TF32) in cuBLAS matmuls and cuDNN convolutions for
    the block, on a CUDA device; the flags are restored when the last open
    block (on any thread) closes. The JAX package pins ``precision=HIGHEST``
    or ``"float32"`` per product for the same reason."""
    if device.type != "cuda":
        yield
        return
    with _Fp32Blocks.lock:
        if _Fp32Blocks.depth == 0:
            _Fp32Blocks.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _Fp32Blocks.depth += 1
    try:
        yield
    finally:
        with _Fp32Blocks.lock:
            _Fp32Blocks.depth -= 1
            if _Fp32Blocks.depth == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _Fp32Blocks.saved


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


def tie_group_bounds(changed: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-position tie-group start/end indices from an adjacent-change mask
    (``metrics_tpu/utilities/data.py:49``).

    ``changed`` is the ``(n-1,)`` boolean mask ``key[1:] != key[:-1]`` over a
    SORTED key sequence; returns ``(start_idx, end_idx)``, both ``(n,)``
    int64, where position ``i`` carries the first/last index of its tie
    group. The JAX package takes a running maximum of the group starts and a
    running minimum of the ends from the back (``lax.cummax``/``cummin``);
    on the card ``torch.cummax``/``cummin`` of one long row run as a scan of
    one row (1.4 ms each at n = 1,000,000 on an H100), so the port numbers
    the groups with a ``cumsum`` of the starts and scatters each group's
    first and last position into a table read back by group: O(n) parallel
    work, no host read.
    """
    n = changed.shape[0] + 1
    idx = torch.arange(n, device=changed.device)
    edge = torch.ones((1,), dtype=torch.bool, device=changed.device)
    is_start = torch.cat([edge, changed])
    is_end = torch.cat([changed, edge])
    group = torch.cumsum(is_start, dim=0) - 1
    # row n of each table takes the positions that are no start (no end);
    # out-of-place scatters, which torch.func.vmap batches into a fresh table
    table = torch.zeros(n + 1, dtype=idx.dtype, device=idx.device)
    starts = torch.scatter(table, 0, torch.where(is_start, group, n), idx)
    ends = torch.scatter(table, 0, torch.where(is_end, group, n), idx)
    return starts[group], ends[group]


def get_group_indexes(indexes: Tensor) -> List[Tensor]:
    """Positions of each distinct value of ``indexes``, grouped, the groups
    in order of first appearance (``data.py:172``): int32 tensors on the
    ids' device. A sort, not the reference's per-element loop; the split
    reads the group sizes to the host once."""
    idx = indexes.reshape(-1)
    _, inverse, counts = torch.unique(idx, sorted=True, return_inverse=True, return_counts=True)
    order = torch.sort(inverse, stable=True).indices  # positions grouped by sorted-unique value
    first_pos = order[torch.cumsum(counts, 0) - counts]  # each group's first position
    splits = torch.split(order.to(torch.int32), to_host(counts))
    return [splits[g] for g in to_host(torch.sort(first_pos).indices)]


def dim_zero_sum(x: Tensor) -> Tensor:
    # in the states' dtype: torch.sum would promote an int32 count to int64
    return torch.sum(x, dim=0, dtype=x.dtype)


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
        if _is_traced(label_tensor):
            raise ValueError("`num_classes` must be given explicitly when one-hot encoding inside a traced program.")
        num_classes = int(to_host(label_tensor.max())) + 1
    classes = _class_axis(num_classes, label_tensor.ndim + 1, label_tensor.device)
    return (label_tensor.unsqueeze(1) == classes).to(label_tensor.dtype)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """Binarize by marking the top-k entries along ``dim`` with 1 (int32 output)."""
    if topk == 1:
        top_idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
        moved = top_idx.movedim(dim, 1)
        classes = _class_axis(prob_tensor.shape[dim], moved.ndim, prob_tensor.device)
        return (moved == classes).movedim(1, dim).to(torch.int32)
    # a stable descending sort keeps the lower index first among ties, as the
    # JAX package's ``lax.top_k`` does; ``torch.topk`` leaves their order open
    top_idx = torch.sort(prob_tensor, dim=dim, descending=True, stable=True).indices.narrow(dim, 0, topk)
    # out of place: torch.func.vmap batches a scatter of batched indices into a fresh tensor, not scatter_
    zeros = torch.zeros(prob_tensor.shape, dtype=torch.int32, device=prob_tensor.device)
    return torch.scatter(zeros, dim, top_idx, 1)


def to_categorical(x: Tensor, argmax_dim: int = 1) -> Tensor:
    """Probabilities ``[N, C, d2, ...]`` -> dense labels ``[N, d2, ...]``."""
    return torch.argmax(x, dim=argmax_dim)


def get_num_classes(preds: Tensor, target: Tensor, num_classes: Optional[int] = None) -> int:
    """Infer the number of classes from data values (reads them on the host).

    Inside a traced program no value can be read: ``num_classes`` is then
    returned as given, and raises when it is not."""
    if _is_traced(preds, target):
        if num_classes is None:
            raise ValueError("`num_classes` must be given explicitly inside a traced program.")
        return num_classes
    num_target_classes = int(to_host(target.max())) + 1
    num_pred_classes = int(to_host(preds.max())) + 1
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


# last: the tracer's package imports this module, which must be whole by then
from metrics_tpu_torch.observability.tracing import _NULL_SPAN, HOST_READ, TRACER  # noqa: E402
