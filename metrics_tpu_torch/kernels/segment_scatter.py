"""Segment scatter: the multi-tenant keyed update's routing of rows to tenants.

Counterpart of ``metrics_tpu/kernels/segment_scatter.py``. Rows of per-row
state deltas, routed by segment (tenant) id, reduce into ``(S, D)`` float32
per-segment results plus ``(S,)`` int32 counts of valid rows; an id < 0 or
>= S is dropped from both. Three functions, each in two formulations:

* :func:`segment_scatter_add_torch`, :func:`segment_scatter_max_torch`,
  :func:`segment_scatter_min_torch`, the plain versions: ``index_add_`` or
  ``scatter_reduce_`` into an ``S+1``-row buffer whose last row takes the
  invalid ids and is cut off (the ``_xla`` formulations of the JAX package).
  Their cores, :func:`segment_sum_plain` and :func:`segment_extremal_plain`,
  keep the rows' own dtype: the keyed update routes the leaves the kernels
  do not take exactly (float64, int64) through them, as the JAX package
  routes them through ``segment_sum``/``segment_max``.
* :func:`segment_scatter_add_cuda` (B3) and :func:`segment_scatter_max_cuda`
  / :func:`segment_scatter_min_cuda` (B4), the wrappers of the hand-written
  kernels in ``csrc/segment_scatter.cu`` (which replace the Pallas
  ``_scatter_kernel`` and ``_extremal_kernel``). They take a CUDA tensor to
  the kernel and a CPU tensor to the plain version. On the card a call is
  two ``torch.empty`` outputs and one call into the C library, which makes
  the device current, fills the outputs and scatters in one cooperative
  launch (B3 adds rows as ``float4``/``float2`` vectors where
  :func:`vector_width` allows, one vector atomic each; B4 takes one CAS loop
  per element).

Sums: the kernel adds in f32 in an order that changes from run to run;
integer-valued data whose per-segment sums stay below 2^24 is exact, other
floats agree with the plain version to rounding. Extrema follow XLA's
``segment_max``/``segment_min`` exactly: a NaN row makes its segment NaN,
+0.0 is above -0.0 whatever the row order, and an empty segment keeps the
identity (-inf for max, +inf for min), which callers mask with
``counts > 0``. ``scatter_reduce_`` alone keeps the first of two equal zeros
and may drop NaN on the card, so the plain extrema set both with explicit
terms.

The merge, :func:`segment_merge_cuda` (plain version
:func:`segment_merge_torch`), is the keyed update's routing in one call: a
list of leaves, each ``(rows, state, default, op)`` with ``(R, ...)`` rows,
the ``(S, ...)`` stacked state, the leaf's default and ``op`` ``"sum"``,
``"max"`` or ``"min"``, all int32 or all float32, becomes each leaf's new
state (a sum adds ``rows - default`` into it, an extremum picks in XLA's
order against it, a segment without rows keeps it), with the ``(S,)`` int32
counts of valid rows and the 0-d int32 count of dropped ids. On the card it
is one call into the C library and one cooperative launch
(``csrc/segment_scatter.cu``, ``segment_merge_launch``) that reads every
leaf's rows in place at their row stride (0 for a broadcast default) and
writes new output tensors, so the update stays out of place. int32 sums are
exact at any size (integer atomics); float32 sums take the batch's sum first
and then ``state + sum``, in an order of adds that changes from run to run.
The plain version is the per-leaf route: ``index_add_`` in the leaf's dtype,
``state + sum``, and the plain extrema picked against the state in XLA's
order.
"""
import ctypes
import struct
from typing import Dict, List, Sequence, Tuple, Union

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

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
)
_ENTRY = "segment_scatter_launch"
#: the C entry's ``op`` argument
_ADD, _MAX, _MIN = 0, 1, 2
#: the kernels index rows in 32 bits: ``R * max(D, 1)`` stays below this
_MAX_ITEMS = 2**31
#: largest segment count the int32 counts and the JAX package's int32 ids address
_MAX_SEGMENTS = 2**31 - 1

_MERGE_ARGTYPES = (
    ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
)
_MERGE_ENTRY = "segment_merge_launch"
#: a merged leaf's op; its kind in the C entry's table is ``op * 2 + 1`` for float32, ``op * 2`` for int32
_MERGE_OPS = {"sum": 0, "max": 1, "min": 2}
#: the leaf dtypes the merge takes
MERGE_DTYPES = (torch.int32, torch.float32)
#: a leaf's row in the C entry's table, int64 each: rows, row stride, state, out, default, D, V, kind
_MERGE_FIELDS = 8
#: ``{leaves: struct}`` packing a table of that many leaves
_MERGE_TABLES: Dict[int, struct.Struct] = {}
#: one merged leaf: ``(rows, state, default, op)``
MergeLeaf = Tuple[Tensor, Tensor, Tensor, str]


def _safe_ids(segment_ids: Tensor, num_segments: int) -> Tuple[Tensor, Tensor]:
    """``(valid mask, ids with every invalid id sent to the discard row S)``."""
    ids = segment_ids.reshape(-1).long()
    valid = (ids >= 0) & (ids < num_segments)
    return valid, torch.where(valid, ids, num_segments)


def _counts(valid: Tensor, safe: Tensor, num_segments: int) -> Tensor:
    counts = torch.zeros(num_segments + 1, dtype=torch.int32, device=safe.device)
    return counts.index_add_(0, safe, valid.to(torch.int32))[:num_segments]


def segment_sum_plain(rows: Tensor, safe: Tensor, num_segments: int) -> Tensor:
    """``(S, D)`` sums of ``(R, D)`` rows in the rows' own dtype, routed by
    ``safe`` ids (:func:`_safe_ids`: invalid ids sent to the discard row)."""
    sums = torch.zeros((num_segments + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return sums.index_add_(0, safe, rows)[:num_segments]


def segment_extremal_plain(rows: Tensor, safe: Tensor, num_segments: int, op: str) -> Tensor:
    """``(S, D)`` maxima (``op="max"``) or minima of ``(R, D)`` rows in the
    rows' own dtype, routed as :func:`segment_sum_plain`; in XLA's order
    for floats (NaN on top, +0.0 above -0.0). An empty segment holds the
    identity: -inf/+inf for floats, the dtype's least/greatest integer."""
    is_max = op == "max"
    floating = rows.is_floating_point()
    if floating:
        fill = float("-inf") if is_max else float("inf")
    else:
        info = torch.iinfo(rows.dtype)
        fill = info.min if is_max else info.max
    shape = (num_segments + 1, rows.shape[1])
    index = safe.unsqueeze(1).expand_as(rows)
    ext = torch.full(shape, fill, dtype=rows.dtype, device=rows.device)
    if not floating:
        return ext.scatter_reduce_(0, index, rows, "amax" if is_max else "amin", include_self=True)[:num_segments]
    nan = torch.isnan(rows)
    ext.scatter_reduce_(0, index, torch.where(nan, fill, rows), "amax" if is_max else "amin", include_self=True)
    # the zero of the winning sign: +0.0 for max if any row holds +0.0, -0.0
    # for min if any holds -0.0; NaN wherever a row is NaN
    winning_zero = (rows == 0) & (torch.signbit(rows) != is_max)
    any_zero = torch.zeros(shape, dtype=torch.int32, device=rows.device).index_add_(0, safe, winning_zero.int()) > 0
    any_nan = torch.zeros(shape, dtype=torch.int32, device=rows.device).index_add_(0, safe, nan.int()) > 0
    ext = torch.where((ext == 0) & any_zero, 0.0 if is_max else -0.0, ext)
    ext = torch.where(any_nan, float("nan"), ext)
    return ext[:num_segments]


def segment_scatter_add_torch(rows: Tensor, segment_ids: Tensor, num_segments: int) -> Tuple[Tensor, Tensor]:
    """``((S, D) float32 sums, (S,) int32 counts)`` of ``(R, D)`` rows by id."""
    valid, safe = _safe_ids(segment_ids, num_segments)
    return segment_sum_plain(rows.to(torch.float32), safe, num_segments), _counts(valid, safe, num_segments)


def _segment_scatter_extremal_torch(
    rows: Tensor, segment_ids: Tensor, num_segments: int, op: str
) -> Tuple[Tensor, Tensor]:
    valid, safe = _safe_ids(segment_ids, num_segments)
    ext = segment_extremal_plain(rows.to(torch.float32), safe, num_segments, op)
    return ext, _counts(valid, safe, num_segments)


def segment_scatter_max_torch(rows: Tensor, segment_ids: Tensor, num_segments: int) -> Tuple[Tensor, Tensor]:
    """``((S, D) float32 maxima, (S,) int32 counts)``; empty segments hold -inf."""
    return _segment_scatter_extremal_torch(rows, segment_ids, num_segments, "max")


def segment_scatter_min_torch(rows: Tensor, segment_ids: Tensor, num_segments: int) -> Tuple[Tensor, Tensor]:
    """``((S, D) float32 minima, (S,) int32 counts)``; empty segments hold +inf."""
    return _segment_scatter_extremal_torch(rows, segment_ids, num_segments, "min")


def vector_width(d: int, address: int) -> int:
    """Floats per vector access of the B3 kernel for rows of width ``d``.

    ``address`` is the bitwise OR of the pointers the vectors touch (the rows
    and the sums), whose low bits are zero only where every pointer's are:
    4 (``float4``) where ``d % 4 == 0`` and ``address`` is 16-byte aligned, 2
    (``float2``) where ``d`` is even and ``address`` 8-byte aligned, else 1.
    Row ``i`` starts ``4 * d * i`` bytes after the first, so the first row's
    alignment holds for every row.
    """
    if d % 4 == 0 and address % 16 == 0:
        return 4
    if d % 2 == 0 and address % 8 == 0:
        return 2
    return 1


def _check(op: str, rows: Tensor, segment_ids: Tensor, num_segments: int, device: torch.device) -> None:
    # attribute reads first; method calls and the device comparison last
    if rows.ndim != 2 or segment_ids.ndim != 1 or segment_ids.shape[0] != rows.shape[0]:
        raise ValueError(f"{op} takes rows of shape (R, D) and ids of shape (R,), got {tuple(rows.shape)} and"
                         f" {tuple(segment_ids.shape)}")
    if not 1 <= num_segments <= _MAX_SEGMENTS:
        raise ValueError(f"{op} takes 1 <= num_segments <= {_MAX_SEGMENTS}, got {num_segments}")
    r, d = rows.shape
    if r * max(d, 1) >= _MAX_ITEMS:
        raise ValueError(f"{op} takes R * max(D, 1) < {_MAX_ITEMS} (the kernels index in 32 bits), got R={r}, D={d}")
    ids_dtype = segment_ids.dtype
    if ids_dtype.is_floating_point or ids_dtype.is_complex or ids_dtype == torch.bool:
        raise TypeError(f"{op} takes integer segment ids, got {ids_dtype}")
    if device.type == "cuda":
        if rows.dtype != torch.float32 or ids_dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{op} takes float32 rows and int32 or int64 ids, got {rows.dtype} and {ids_dtype}")
        if not (rows.is_contiguous() and segment_ids.is_contiguous()):
            raise ValueError(f"{op} takes contiguous inputs")
        check_device(device, rows, segment_ids)
        require_capability(device)
    elif device.type == "cpu":
        check_device(device, rows, segment_ids)
    else:
        raise ValueError(f"{op} runs on a CUDA or the CPU device, not on {device}")


def _scatter_cuda(name: str, op: int, rows: Tensor, segment_ids: Tensor, num_segments: int,
                  device: torch.device) -> Tuple[Tensor, Tensor]:
    """One call into the C library, which fills the uninitialised outputs and
    scatters into them in one launch on the current stream of ``device``."""
    r, d = rows.shape
    # the shape as separate arguments: as a tuple it took 10-35% more host time on the H100's host
    out = torch.empty(num_segments, d, dtype=torch.float32, device=device)
    counts = torch.empty(num_segments, dtype=torch.int32, device=device)
    rows_ptr, out_ptr = rows.data_ptr(), out.data_ptr()
    vec = vector_width(d, rows_ptr | out_ptr) if op == _ADD else 1
    err = kernel_function(_ENTRY, _ARGTYPES)(
        rows_ptr, segment_ids.data_ptr(), r, d, num_segments, segment_ids.element_size(), op, vec, out_ptr,
        counts.data_ptr(), device.index, current_stream_handle(device))
    check_launch(name, err)
    note_kernel_dispatch(name, "cuda")
    return out, counts


def segment_scatter_add_cuda(
    rows: Tensor, segment_ids: Tensor, num_segments: int, device: Union[str, torch.device] = "cuda"
) -> Tuple[Tensor, Tensor]:
    """``((S, D) float32 sums, (S,) int32 counts)`` of ``(R, D)`` rows lying on ``device``.

    On a CUDA device the B3 kernel adds (float32 rows, int32 or int64 ids);
    on the CPU the plain version does. Raises on inputs the kernel does not
    take.
    """
    op = "segment_scatter_add"
    device = kernel_device(device)
    _check(op, rows, segment_ids, num_segments, device)
    if device.type == "cpu":
        note_kernel_dispatch(op, "torch")
        return segment_scatter_add_torch(rows, segment_ids, num_segments)
    return _scatter_cuda(op, _ADD, rows, segment_ids, num_segments, device)


def _segment_scatter_extremal_cuda(
    rows: Tensor, segment_ids: Tensor, num_segments: int, op: str, device: Union[str, torch.device]
) -> Tuple[Tensor, Tensor]:
    name = f"segment_scatter_{op}"
    device = kernel_device(device)
    _check(name, rows, segment_ids, num_segments, device)
    if device.type == "cpu":
        note_kernel_dispatch(name, "torch")
        return _segment_scatter_extremal_torch(rows, segment_ids, num_segments, op)
    return _scatter_cuda(name, _MAX if op == "max" else _MIN, rows, segment_ids, num_segments, device)


def segment_scatter_max_cuda(
    rows: Tensor, segment_ids: Tensor, num_segments: int, device: Union[str, torch.device] = "cuda"
) -> Tuple[Tensor, Tensor]:
    """``((S, D) float32 maxima, (S,) int32 counts)`` of ``(R, D)`` rows lying on ``device``.

    On a CUDA device the B4 kernel picks (float32 rows); on the CPU the plain
    version does. Empty segments hold -inf. Raises on inputs the kernel does
    not take.
    """
    return _segment_scatter_extremal_cuda(rows, segment_ids, num_segments, "max", device)


def segment_scatter_min_cuda(
    rows: Tensor, segment_ids: Tensor, num_segments: int, device: Union[str, torch.device] = "cuda"
) -> Tuple[Tensor, Tensor]:
    """:func:`segment_scatter_max_cuda` for minima; empty segments hold +inf."""
    return _segment_scatter_extremal_cuda(rows, segment_ids, num_segments, "min", device)


# --------------------------------------------------------------------------
# the merge: every int32/float32 leaf of a keyed update in one launch
# --------------------------------------------------------------------------


def _ordered_pick(state: Tensor, seg: Tensor, is_max: bool) -> Tensor:
    """``state`` or ``seg``, whichever wins a max (``is_max``) or a min in
    XLA's order: NaN on top, +0.0 above -0.0 (B4's ``beats``). An empty
    segment's identity (-inf, +inf, or the integer extremes) never wins."""
    if not state.is_floating_point():
        return torch.maximum(state, seg) if is_max else torch.minimum(state, seg)
    wins = seg > state if is_max else seg < state
    sign = torch.signbit(state) & ~torch.signbit(seg) if is_max else ~torch.signbit(state) & torch.signbit(seg)
    wins = wins | ((seg == state) & sign) | (torch.isnan(seg) & ~torch.isnan(state))
    return torch.where(wins, seg, state)


def segment_merge_torch(leaves: Sequence[MergeLeaf], segment_ids: Tensor, num_segments: int
                        ) -> Tuple[List[Tensor], Tensor, Tensor]:
    """``(new states, (S,) int32 counts, 0-d int32 dropped ids)`` of the
    merge (see the module docstring), one leaf at a time: a sum leaf's
    ``rows - default`` summed by ``index_add_`` in its own dtype and added to
    the state, an extremal leaf's rows picked in XLA's order
    (:func:`segment_extremal_plain`) and then against the state."""
    valid, safe = _safe_ids(segment_ids, num_segments)
    outs = []
    for rows, state, default, op in leaves:
        r, d = rows.shape[0], default.numel()
        if op == "sum":
            sums = segment_sum_plain((rows - default).reshape(r, d), safe, num_segments)
            outs.append(state + sums.reshape(state.shape))
        else:
            seg = segment_extremal_plain(rows.reshape(r, d), safe, num_segments, op).reshape(state.shape)
            outs.append(_ordered_pick(state, seg, op == "max"))
    return outs, _counts(valid, safe, num_segments), (~valid).sum().to(torch.int32)


def _check_merge(leaves: Sequence[MergeLeaf], segment_ids: Tensor, num_segments: int, device: torch.device) -> None:
    # attribute reads and element counts only: the shapes' slices cost the
    # host more than the rest of a leaf's checks
    name = "segment_merge"
    if segment_ids.ndim != 1:
        raise ValueError(f"{name} takes ids of shape (R,), got {tuple(segment_ids.shape)}")
    if not 1 <= num_segments <= _MAX_SEGMENTS:
        raise ValueError(f"{name} takes 1 <= num_segments <= {_MAX_SEGMENTS}, got {num_segments}")
    ids_dtype = segment_ids.dtype
    if ids_dtype.is_floating_point or ids_dtype.is_complex or ids_dtype == torch.bool:
        raise TypeError(f"{name} takes integer segment ids, got {ids_dtype}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on a CUDA or the CPU device, not on {device}")
    cuda = device.type == "cuda"
    # Tensor.get_device(): the CUDA index, -1 on the CPU
    where = device.index if cuda else -1
    r = segment_ids.shape[0]
    items = r
    for rows, state, default, op in leaves:
        if op not in _MERGE_OPS:
            raise ValueError(f"{name} takes the ops {list(_MERGE_OPS)}, got {op!r}")
        dtype = state.dtype
        if dtype not in MERGE_DTYPES or rows.dtype != dtype or default.dtype != dtype:
            raise TypeError(f"{name} takes int32 or float32 leaves whose rows, state and default share the dtype,"
                            f" got {rows.dtype}, {dtype} and {default.dtype}")
        d = default.numel()
        ndim = default.ndim + 1
        if state.ndim != ndim or rows.ndim != ndim or state.shape[0] != num_segments or rows.shape[0] != r or \
                state.numel() != num_segments * d or rows.numel() != r * d:
            raise ValueError(f"{name} takes rows (R, ...), state (S, ...) and a default (...) of one leaf shape, with"
                             f" R={r} and S={num_segments}; got {tuple(rows.shape)}, {tuple(state.shape)} and"
                             f" {tuple(default.shape)}")
        if cuda and not (state.is_contiguous() and default.is_contiguous()):
            raise ValueError(f"{name} takes contiguous states and defaults")
        if rows.get_device() != where or state.get_device() != where or default.get_device() != where:
            raise ValueError(f"{name}: expected the leaves on {device}, got {rows.device}, {state.device} and"
                             f" {default.device}")
        items += r * d
    if items >= _MAX_ITEMS:
        raise ValueError(f"{name} takes R * (1 + the leaves' widths) < {_MAX_ITEMS} (the kernel indexes in 32 bits),"
                         f" got {items}")
    check_device(device, segment_ids)
    if cuda:
        if ids_dtype not in (torch.int32, torch.int64) or not segment_ids.is_contiguous():
            raise TypeError(f"{name} takes contiguous int32 or int64 ids, got {ids_dtype}")
        require_capability(device)


def _row_view(rows: Tensor, r: int, d: int) -> Tuple[Tensor, int]:
    """``(rows as (R, D) whose row elements are adjacent, their row stride in
    elements)``: the rows themselves or a view of them where their layout
    allows (a broadcast default's stride 0, a slice of B1's batched output),
    else a contiguous copy."""
    if rows.ndim == 1 or (rows.ndim == 2 and (d <= 1 or rows.stride(1) == 1)):
        return rows, rows.stride(0)
    flat = rows.reshape(r, d)
    if d > 1 and flat.stride(1) != 1:
        flat = flat.contiguous()
    return flat, flat.stride(0)


def _merge_table(n: int) -> struct.Struct:
    table = _MERGE_TABLES.get(n)
    if table is None:
        table = _MERGE_TABLES.setdefault(n, struct.Struct(f"<{n * _MERGE_FIELDS}q"))
    return table


def _merge_cuda(leaves: Sequence[MergeLeaf], segment_ids: Tensor, num_segments: int, device: torch.device
                ) -> Tuple[List[Tensor], Tensor, Tensor]:
    """One call into the C library: the leaves' table packed by value, the
    outputs, counts and dropped count allocated uninitialised (the launch
    fills them), one launch on the current stream of ``device``."""
    r = segment_ids.shape[0]
    fields: List[int] = []
    outs, views = [], []
    for rows, state, default, op in leaves:
        d = default.numel()
        view, stride = _row_view(rows, r, d)
        out = torch.empty_like(state)
        rows_ptr, out_ptr, default_ptr = view.data_ptr(), out.data_ptr(), default.data_ptr()
        # the row stride's bytes join the address: every row then shares the first one's alignment
        vec = vector_width(d, rows_ptr | out_ptr | default_ptr | 4 * stride)
        kind = _MERGE_OPS[op] * 2 + (state.dtype == torch.float32)
        fields += (rows_ptr, stride, state.data_ptr(), out_ptr, default_ptr, d, vec, kind)
        outs.append(out)
        views.append(view)
    counts = torch.empty(num_segments, dtype=torch.int32, device=device)
    invalid = torch.empty((), dtype=torch.int32, device=device)
    err = kernel_function(_MERGE_ENTRY, _MERGE_ARGTYPES)(
        _merge_table(len(leaves)).pack(*fields), len(leaves), segment_ids.data_ptr(), r, num_segments,
        segment_ids.element_size(), counts.data_ptr(), invalid.data_ptr(), device.index, current_stream_handle(device))
    check_launch("segment_merge", err)
    note_kernel_dispatch("segment_merge", "cuda")
    return outs, counts, invalid


def segment_merge_cuda(
    leaves: Sequence[MergeLeaf], segment_ids: Tensor, num_segments: int, device: Union[str, torch.device] = "cuda"
) -> Tuple[List[Tensor], Tensor, Tensor]:
    """``(new states, (S,) int32 counts, 0-d int32 dropped ids)`` of the
    merge (see the module docstring) of leaves lying on ``device``.

    On a CUDA device one launch of the merge kernel does it (int32 or int64
    ids); on the CPU the plain version does. The states are new tensors.
    Raises on inputs the kernel does not take.
    """
    device = kernel_device(device)
    _check_merge(leaves, segment_ids, num_segments, device)
    if device.type == "cpu":
        note_kernel_dispatch("segment_merge", "torch")
        return segment_merge_torch(leaves, segment_ids, num_segments)
    return _merge_cuda(leaves, segment_ids, num_segments, device)
