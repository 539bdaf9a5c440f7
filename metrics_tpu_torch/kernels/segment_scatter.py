"""Segment scatter: the multi-tenant keyed update's routing of rows to tenants.

Counterpart of ``metrics_tpu/kernels/segment_scatter.py``. Rows of per-row
state deltas, routed by segment (tenant) id, reduce into ``(S, D)`` float32
per-segment results plus ``(S,)`` int32 counts of valid rows; an id < 0 or
>= S is dropped from both. Three functions, each in two formulations:

* :func:`segment_scatter_add_torch`, :func:`segment_scatter_max_torch`,
  :func:`segment_scatter_min_torch`, the plain versions: ``index_add_`` or
  ``scatter_reduce_`` into an ``S+1``-row buffer whose last row takes the
  invalid ids and is cut off (the ``_xla`` formulations of the JAX package).
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


def _safe_ids(segment_ids: Tensor, num_segments: int) -> Tuple[Tensor, Tensor]:
    """``(valid mask, ids with every invalid id sent to the discard row S)``."""
    ids = segment_ids.reshape(-1).long()
    valid = (ids >= 0) & (ids < num_segments)
    return valid, torch.where(valid, ids, num_segments)


def _counts(valid: Tensor, safe: Tensor, num_segments: int) -> Tensor:
    counts = torch.zeros(num_segments + 1, dtype=torch.int32, device=safe.device)
    return counts.index_add_(0, safe, valid.to(torch.int32))[:num_segments]


def segment_scatter_add_torch(rows: Tensor, segment_ids: Tensor, num_segments: int) -> Tuple[Tensor, Tensor]:
    """``((S, D) float32 sums, (S,) int32 counts)`` of ``(R, D)`` rows by id."""
    valid, safe = _safe_ids(segment_ids, num_segments)
    sums = torch.zeros((num_segments + 1, rows.shape[1]), dtype=torch.float32, device=rows.device)
    sums.index_add_(0, safe, rows.to(torch.float32))
    return sums[:num_segments], _counts(valid, safe, num_segments)


def _segment_scatter_extremal_torch(
    rows: Tensor, segment_ids: Tensor, num_segments: int, op: str
) -> Tuple[Tensor, Tensor]:
    valid, safe = _safe_ids(segment_ids, num_segments)
    is_max = op == "max"
    fill = float("-inf") if is_max else float("inf")
    x = rows.to(torch.float32)
    shape = (num_segments + 1, x.shape[1])
    index = safe.unsqueeze(1).expand_as(x)
    nan = torch.isnan(x)
    ext = torch.full(shape, fill, dtype=torch.float32, device=x.device)
    ext.scatter_reduce_(0, index, torch.where(nan, fill, x), "amax" if is_max else "amin", include_self=True)
    # the zero of the winning sign: +0.0 for max if any row holds +0.0, -0.0
    # for min if any holds -0.0; NaN wherever a row is NaN
    winning_zero = (x == 0) & (torch.signbit(x) != is_max)
    any_zero = torch.zeros(shape, dtype=torch.int32, device=x.device).index_add_(0, safe, winning_zero.int()) > 0
    any_nan = torch.zeros(shape, dtype=torch.int32, device=x.device).index_add_(0, safe, nan.int()) > 0
    ext = torch.where((ext == 0) & any_zero, 0.0 if is_max else -0.0, ext)
    ext = torch.where(any_nan, float("nan"), ext)
    return ext[:num_segments], _counts(valid, safe, num_segments)


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


def _kernel_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` resolved: a ``torch.device`` that names its index, as the
    keyed metrics pass theirs, is taken as it is (without a card no tensor
    lies on a CUDA device, so the device check still raises); anything else
    goes through :func:`resolve_device`."""
    if type(device) is torch.device and device.index is not None:
        return device
    return resolve_device(device)


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
    device = _kernel_device(device)
    _check(op, rows, segment_ids, num_segments, device)
    if device.type == "cpu":
        note_kernel_dispatch(op, "torch")
        return segment_scatter_add_torch(rows, segment_ids, num_segments)
    return _scatter_cuda(op, _ADD, rows, segment_ids, num_segments, device)


def _segment_scatter_extremal_cuda(
    rows: Tensor, segment_ids: Tensor, num_segments: int, op: str, device: Union[str, torch.device]
) -> Tuple[Tensor, Tensor]:
    name = f"segment_scatter_{op}"
    device = _kernel_device(device)
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
