"""Label/score sketch histograms and binned precision-recall counts.

Counterpart of ``metrics_tpu/kernels/binned_counts.py``.

:func:`label_score_histograms` feeds every ``sketched=True`` curve state:
each ``(N, C)`` score is bucketed once on a fixed ascending grid of
``num_bins`` bins over ``[lo, hi]`` and counted into one of two ``(C, B)``
float32 histograms by its label (``target == 1`` positive, anything else
negative), plus the float32 count of scores outside ``[lo, hi]``. Two
formulations:

* :func:`label_score_histograms_torch`, the plain version and oracle (the
  ``label_score_histograms_xla`` of the JAX package): one out-of-place
  ``scatter_add`` of ones over the flat ``(label, class, bin)`` index, safe
  under ``torch.func.vmap``.
* :func:`label_score_histograms_cuda` (B5), the wrapper of the hand-written
  kernel ``csrc/binned_counts.cu`` (which replaces the Pallas
  ``_hist_kernel``). It takes a CUDA tensor to the kernel and a CPU tensor
  to the plain version. On the card a call is three ``torch.empty`` outputs
  and one call into the C library under a plan chosen here
  (:func:`histogram_plan`): blocks count tiles of class columns in shared
  memory and store each output tile once, or, for few columns and many
  rows, add their chunks' counts to outputs that the same cooperative
  launch zeroes first. The kernel writes every output element, so nothing
  is filled beforehand.

The multiclass one-vs-rest case hands its ``(N,)`` class ids over in place
of their ``(N, C)`` one-hot (:func:`_label_score_histograms_onevsrest`):
the kernel counts a score as positive where its row's id equals its column.

The batched form is ``jax.vmap`` of the Pallas kernel, which ``pallas_call``'s
batching rule runs over a stack: the keyed path's per-row updates and the
pure ``BootStrapper``'s resamples, both under ``torch.func.vmap``:

* :func:`label_score_histograms_batched_torch`, its plain version: one
  out-of-place ``scatter_add`` over the flat ``(slice, label, class, bin)``
  index of an ``(R, N, C)`` stack, with dense ``(R, N, C)`` labels or
  ``(R, N)`` class ids;
* :func:`label_score_histograms_batched_cuda`, the wrapper of the kernel's
  batched entry (``label_score_histograms_batched_launch``): one C call and
  three ``torch.empty`` outputs, ``(R, C, B)`` twice and ``(R,)``, every
  slice counted as one call of the single form counts it
  (:func:`batched_histogram_plan`);
* :func:`label_score_histograms_stacked`, the seam's call inside the vmap:
  its vmap rule (``_common.vmap_stack``) hands the whole stack to the
  batched wrapper in one launch.

Both give the JAX package's histograms bit for bit. The bin index is
``floor((x - lo) / span * num_bins)`` in float32, in that order, clipped to
``[0, num_bins - 1]``, with ``lo``, ``span = hi - lo`` (taken in double) and
``num_bins`` each rounded once to float32, as JAX's weak-typed scalars are.
A NaN score lands in bin 0 and is not counted as clipped; +-inf clip into
the edge bins and are counted; a subnormal score counts as zero, as XLA
(CPU and TPU) reads it, so a tiny negative score is not clipped below
``lo = 0``. The plain version divides by ``span`` held
in a tensor on the scores' device: PyTorch's CUDA division by a Python
scalar multiplies by its reciprocal instead, which can move a score on a
bin edge into the next bin. Counts are float32, exact while one call puts
fewer than 2^24 scores into one bin.

:func:`binned_tp_fp_fn` stays plain PyTorch, as the JAX package keeps it a
compiler-fused compare (no Pallas kernel backs it).
"""
import ctypes
from functools import lru_cache
from typing import NamedTuple, Tuple, Union

import torch

from metrics_tpu_torch.kernels._common import (
    check_launch,
    current_stream_handle,
    kernel_device,
    kernel_function,
    note_kernel_dispatch,
    require_capability,
    sm_count,
    vmap_stack,
)
from metrics_tpu_torch.utilities.data import Tensor, _is_batched, check_device, to_onehot

_OP = "label_score_histograms"
_ENTRY = "label_score_histograms_launch"
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
)
_BATCHED_ENTRY = "label_score_histograms_batched_launch"
_BATCHED_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
)
#: largest cell count 2 * C * num_bins the wrapper takes (num_bins reaches the kernel as a 32-bit int)
_MAX_CELLS = 2**31 - 1
#: the kernel counts rows in 32 bits
_MAX_ROWS = 2**31 - 1
#: the smallest normal float32; scores of smaller magnitude count as zero
_TINY = torch.finfo(torch.float32).tiny

#: the kernel's modes (the C entry's ``mode`` argument)
STORE, ADD, GLOBAL = 0, 1, 2
#: the C entry's ``label_form`` argument: dense (N, C) int32 labels
_DENSE = 0
#: shared memory a block's two count tiles may take: the 227 KB a block of an
#: H100 can opt into, less 1 KB for the kernel's static shared memory
SHARED_BUDGET = 227 * 1024 - 1024
_THREADS = 1024
#: the most scores of its tile one block walks alone before the rows are cut
#: into chunks (at the binary stream's 10,000 one block that stores took 6.4 us
#: on the H100, 20 to 40 chunks that add 4.7)
_ONE_CHUNK_ITEMS = 2 * _THREADS
#: the fewest scores per block that the chunks of the add mode aim at
_CHUNK_ITEMS = 512
#: threads of an add-mode block with few scores and small count tiles
_SMALL_THREADS, _SMALL_ITEMS, _SMALL_SHARED = 256, 1024, 32 * 1024
_MAX_CHUNKS = 65535

Histograms = Tuple[Tensor, Tensor, Tensor]


class HistogramPlan(NamedTuple):
    """How the B5 kernel cuts one call: ``tiles`` of ``k`` class columns times
    ``chunks`` of ``rows_per_chunk`` rows, one block of ``threads`` each, whose
    two count tiles take ``shared_bytes`` of shared memory."""

    mode: int
    k: int
    tiles: int
    chunks: int
    rows_per_chunk: int
    threads: int
    shared_bytes: int


def tile_shared_bytes(k: int, num_bins: int) -> int:
    """Bytes of the two ``(k, num_bins)`` uint32 count tiles, each padded to 16 bytes."""
    return 2 * ((k * num_bins + 3) // 4 * 4) * 4


def _columns_that_fit(num_bins: int) -> int:
    """How many class columns' two count tiles fit in ``SHARED_BUDGET``."""
    fits = SHARED_BUDGET // tile_shared_bytes(1, num_bins)
    while tile_shared_bytes(fits, num_bins) > SHARED_BUDGET:  # the padding of an odd tile
        fits -= 1
    return fits


@lru_cache(maxsize=256)
def histogram_plan(n: int, c: int, num_bins: int, sms: int = 132) -> HistogramPlan:
    """The B5 kernel's plan for ``(n, c)`` scores on ``num_bins`` bins, on a
    card of ``sms`` multiprocessors.

    * The tile width ``k``: as many columns as fit (``2 * k * num_bins * 4``
      bytes within ``SHARED_BUDGET``), cut down until the tiles fill the card, and
      a multiple of 8 where ``c`` and the budget allow, so that a row's ``k``
      floats are whole 32-byte sectors.
    * ``STORE`` with one chunk where the tiles fill at least half the card
      or one block walks its tile's scores alone quickly enough: every block
      owns its output tile and stores it.
    * ``ADD`` otherwise (few columns, many rows): the rows are cut into
      chunks of at least ``_CHUNK_ITEMS`` scores (more where the count tiles
      are large, since every block zeroes and reads out its own), at most
      until the grid fills the card (one block per multiprocessor: the launch
      is cooperative), and the blocks add to the output.
    * ``GLOBAL`` where not even one column fits (``num_bins`` above about
      28,000): no shared memory, no tiles.
    """
    if tile_shared_bytes(1, num_bins) > SHARED_BUDGET:
        return HistogramPlan(GLOBAL, 0, 0, 0, n, 0, 0)
    fits = _columns_that_fit(num_bins)
    k = min(c, fits)
    if c >= 8 and fits >= 8:
        k = min(max(c // sms // 8 * 8, 8), fits // 8 * 8)
    tiles = -(-c // k)
    shared = tile_shared_bytes(k, num_bins)
    chunks = 1
    if 2 * tiles < sms and n * k > _ONE_CHUNK_ITEMS:
        chunks = min(sms // tiles, -(-n * k // max(_CHUNK_ITEMS, shared // 32)), _MAX_CHUNKS)
    rows_per_chunk = -(-max(n, 1) // chunks)
    chunks = -(-max(n, 1) // rows_per_chunk)
    if chunks == 1:
        return HistogramPlan(STORE, k, tiles, 1, rows_per_chunk, _THREADS, shared)
    small = rows_per_chunk * k <= _SMALL_ITEMS and shared <= _SMALL_SHARED
    return HistogramPlan(ADD, k, tiles, chunks, rows_per_chunk, _SMALL_THREADS if small else _THREADS, shared)


@lru_cache(maxsize=256)
def batched_histogram_plan(n: int, c: int, num_bins: int) -> HistogramPlan:
    """The plan of B5's batched entry for a stack of ``(n, c)`` slices on
    ``num_bins`` bins: ``STORE``, one block per (column tile, slice) that
    walks all of its slice's rows, or ``GLOBAL`` where not even one column
    fits in shared memory.

    * The tile width ``k``: every column where they fit (one tile a slice:
      the keyed rows' C = 1 and C = 10 at 2048 bins), else as many as fit, a
      multiple of 8 where the budget allows. The stack's slices fill the
      card, so no column is split off to do so.
    * Threads: 1024 for slices with more than ``_ONE_CHUNK_ITEMS`` scores in
      a tile, else about one thread per four 16-byte stores of the block's
      two output tiles (at least 128): a short slice's block does little
      more than store its tiles.
    """
    if tile_shared_bytes(1, num_bins) > SHARED_BUDGET:
        return HistogramPlan(GLOBAL, 0, 0, 0, n, 0, 0)
    fits = _columns_that_fit(num_bins)
    k = max(c, 1) if c <= fits else (fits // 8 * 8 if fits >= 8 else fits)
    tiles = -(-c // k)
    threads = _THREADS if n * k > _ONE_CHUNK_ITEMS else min(_THREADS, max(128, -(-2 * k * num_bins // 512) * 32))
    return HistogramPlan(STORE, k, tiles, 1, n, threads, tile_shared_bytes(k, num_bins))


def load_width(c: int, k: int, address: int) -> int:
    """Scores per load of the B5 kernel: 4 (16 bytes) where the row stride
    ``c`` and the tile width ``k`` are multiples of 4 and ``address`` (the
    bitwise OR of the pointers the loads touch) is 16-byte aligned, else 1."""
    return 4 if c % 4 == 0 and k % 4 == 0 and address % 16 == 0 else 1


def _bin_index(x: Tensor, num_bins: int, lo: float, hi: float) -> Tensor:
    """int64 bin of each float32 score; NaN goes to bin 0."""
    # a fill on the device (no copy from the host, so it can be captured)
    span = torch.full((), hi - lo, dtype=torch.float32, device=x.device)
    raw = torch.floor((x - lo) / span * num_bins)
    return torch.where(torch.isnan(raw), 0.0, torch.clamp(raw, 0, num_bins - 1)).long()


def label_score_histograms_batched_torch(
    preds: Tensor, labels: Tensor, num_bins: int, lo: float = 0.0, hi: float = 1.0
) -> Histograms:
    """``(pos_hist, neg_hist, clipped)`` of each ``(N, C)`` slice of an
    ``(R, N, C)`` stack: two ``(R, C, num_bins)`` float32 histograms and the
    ``(R,)`` float32 clipped counts. ``labels`` are dense ``(R, N, C)``
    (``== 1`` positive) or ``(R, N)`` integer class ids (positive where the
    id, cut to int32, equals the column; an id outside ``[0, C)`` gives an
    all-negative row), as in the two single forms. The plain version and
    oracle of the batched entry: one out-of-place ``scatter_add`` over the
    flat ``(slice, label, class, bin)`` index, safe under ``torch.func.vmap``."""
    x = preds.to(torch.float32)
    x = torch.where(torch.abs(x) < _TINY, 0.0, x)  # subnormals read as zero, as XLA reads them
    r, _, c = x.shape
    if labels.ndim == x.ndim:
        positive = labels == 1
    else:
        positive = labels.to(torch.int32).unsqueeze(-1) == torch.arange(c, dtype=torch.int32, device=x.device)
    cells = c * num_bins
    flat = (torch.arange(r, device=x.device).view(r, 1, 1) * (2 * cells) + torch.where(positive, 0, cells)
            + torch.arange(c, device=x.device) * num_bins + _bin_index(x, num_bins, lo, hi))
    ones = torch.ones(flat.numel(), dtype=torch.float32, device=x.device)
    hist = torch.zeros(r * 2 * cells, dtype=torch.float32, device=x.device).scatter_add(0, flat.reshape(-1), ones)
    hist = hist.reshape(r, 2, c, num_bins)
    clipped = torch.sum((x < lo) | (x > hi), dim=(1, 2)).to(torch.float32)
    return hist[:, 0], hist[:, 1], clipped


def label_score_histograms_torch(
    preds: Tensor, target: Tensor, num_bins: int, lo: float = 0.0, hi: float = 1.0
) -> Histograms:
    """``(pos_hist, neg_hist, clipped)``: two ``(C, num_bins)`` float32
    histograms of ``(N, C)`` scores split by ``target == 1``, and the float32
    count of scores outside ``[lo, hi]``."""
    x = preds.to(torch.float32)
    x = torch.where(torch.abs(x) < _TINY, 0.0, x)  # subnormals read as zero, as XLA reads them
    c = x.shape[-1]
    cells = c * num_bins
    idx = _bin_index(x, num_bins, lo, hi)
    column = torch.arange(c, device=x.device) * num_bins
    flat = torch.where(target == 1, 0, cells) + column + idx
    ones = torch.ones(flat.shape, dtype=torch.float32, device=x.device).reshape(-1)
    hist = torch.zeros(2 * cells, dtype=torch.float32, device=x.device).scatter_add(0, flat.reshape(-1), ones)
    clipped = torch.sum((x < lo) | (x > hi)).to(torch.float32)
    return hist[:cells].reshape(c, num_bins), hist[cells:].reshape(c, num_bins), clipped


def _onevsrest_torch(preds: Tensor, labels: Tensor, num_bins: int, lo: float = 0.0, hi: float = 1.0) -> Histograms:
    """The plain version of the class-id label form: the dense one-hot of
    the ids (an id outside ``[0, C)`` gives an all-negative row), then
    :func:`label_score_histograms_torch`."""
    onehot = to_onehot(labels.to(torch.int32), num_classes=preds.shape[-1])
    return label_score_histograms_torch(preds, onehot, num_bins, lo, hi)


def _check(preds: Tensor, labels: Tensor, dense: bool, num_bins: int, lo: float, hi: float,
           device: torch.device, stacked: bool = False) -> None:
    # attribute reads first; the device comparison last
    ndim, shape, ids = (3, "(R, N, C)", "(R, N)") if stacked else (2, "(N, C)", "(N,)")
    if dense:
        if preds.ndim != ndim or preds.shape != labels.shape:
            raise ValueError(f"{_OP} takes preds and target of one shape {shape}, got {tuple(preds.shape)} and"
                             f" {tuple(labels.shape)}")
    elif preds.ndim != ndim or labels.shape != preds.shape[:-1]:
        raise ValueError(f"{_OP} takes preds of shape {shape} and class ids of shape {ids}, got"
                         f" {tuple(preds.shape)} and {tuple(labels.shape)}")
    c, n = preds.shape[-1], preds.shape[-2]
    if not (isinstance(num_bins, int) and num_bins >= 1 and 2 * c * num_bins <= _MAX_CELLS):
        raise ValueError(f"{_OP} takes an integer num_bins >= 1 with 2 * C * num_bins <= {_MAX_CELLS}, got"
                         f" {num_bins} at C = {c}")
    if n > _MAX_ROWS:
        raise ValueError(f"{_OP} takes at most {_MAX_ROWS} rows, got {n}")
    if not lo < hi:
        raise ValueError(f"{_OP} needs lo < hi, got {lo} and {hi}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{_OP} runs on a CUDA or the CPU device, not on {device}")
    check_device(device, preds, labels)


def _histograms_cuda(preds: Tensor, labels: Tensor, dense: bool, num_bins: int, lo: float, hi: float,
                     device: torch.device) -> Histograms:
    """One call into the C library, which counts into three uninitialised
    outputs (and writes every element of them) on the current stream of
    ``device``: the single entry for ``(N, C)`` scores, the batched one for
    an ``(R, N, C)`` stack. Inputs the kernel reads as they are pass
    untouched."""
    x = preds if preds.dtype == torch.float32 and preds.is_contiguous() else preds.to(torch.float32).contiguous()
    if dense:
        t = labels if labels.dtype == torch.int32 else (labels == 1).to(torch.int32)
        form = _DENSE
    else:
        t = labels if labels.dtype in (torch.int32, torch.int64) else labels.to(torch.int32)
        form = t.element_size()
    if not t.is_contiguous():
        t = t.contiguous()
    *lead, n, c = x.shape
    # the shapes as separate arguments, one tensor per output: cheaper on the host than views of one buffer
    pos = torch.empty(*lead, c, num_bins, dtype=torch.float32, device=device)
    neg = torch.empty(*lead, c, num_bins, dtype=torch.float32, device=device)
    clipped = torch.empty(lead, dtype=torch.float32, device=device)
    x_ptr, t_ptr = x.data_ptr(), t.data_ptr()
    plan = batched_histogram_plan(n, c, num_bins) if lead else histogram_plan(n, c, num_bins, sm_count(device))
    vec = load_width(c, plan.k, x_ptr | t_ptr if dense else x_ptr)
    if lead:
        err = kernel_function(_BATCHED_ENTRY, _BATCHED_ARGTYPES)(
            x_ptr, t_ptr, form, lead[0], n, c, num_bins, lo, hi, hi - lo, plan.mode, plan.k, plan.threads, vec,
            pos.data_ptr(), neg.data_ptr(), clipped.data_ptr(), device.index, current_stream_handle(device))
    else:
        err = kernel_function(_ENTRY, _ARGTYPES)(
            x_ptr, t_ptr, form, n, c, num_bins, lo, hi, hi - lo, plan.mode, plan.k, plan.chunks, plan.threads, vec,
            pos.data_ptr(), neg.data_ptr(), clipped.data_ptr(), device.index, current_stream_handle(device))
    check_launch(_OP, err)
    note_kernel_dispatch(_OP, "cuda")
    return pos, neg, clipped


def label_score_histograms_cuda(
    preds: Tensor,
    target: Tensor,
    num_bins: int,
    lo: float = 0.0,
    hi: float = 1.0,
    device: Union[str, torch.device] = "cuda",
) -> Histograms:
    """``(pos_hist, neg_hist, clipped)`` of ``(N, C)`` scores lying on ``device``.

    On a CUDA device the B5 kernel counts (scores cast to float32, targets
    other than int32 turned into ``target == 1`` as int32); on the CPU the
    plain version does. Raises on inputs the kernel does not take.
    """
    device = kernel_device(device)
    _check(preds, target, True, num_bins, lo, hi, device)
    if device.type == "cpu":
        note_kernel_dispatch(_OP, "torch")
        return label_score_histograms_torch(preds, target, num_bins, lo, hi)
    require_capability(device)
    return _histograms_cuda(preds, target, True, num_bins, lo, hi, device)


def label_score_histograms_batched_cuda(
    preds: Tensor,
    labels: Tensor,
    num_bins: int,
    lo: float = 0.0,
    hi: float = 1.0,
    device: Union[str, torch.device] = "cuda",
) -> Histograms:
    """``(pos_hist, neg_hist, clipped)`` of each slice of an ``(R, N, C)``
    stack of scores lying on ``device``, with dense ``(R, N, C)`` labels or
    ``(R, N)`` class ids: ``(R, C, num_bins)`` twice and ``(R,)``.

    On a CUDA device the batched B5 entry counts the whole stack in one C
    call; on the CPU the plain version does. Raises on inputs the kernel
    does not take.
    """
    device = kernel_device(device)
    dense = labels.ndim == preds.ndim
    _check(preds, labels, dense, num_bins, lo, hi, device, stacked=True)
    if device.type == "cpu":
        note_kernel_dispatch(_OP, "torch")
        return label_score_histograms_batched_torch(preds, labels, num_bins, lo, hi)
    require_capability(device)
    return _histograms_cuda(preds, labels, dense, num_bins, lo, hi, device)


def label_score_histograms_stacked(
    preds: Tensor, labels: Tensor, num_bins: int, lo: float = 0.0, hi: float = 1.0
) -> Histograms:
    """Histograms of each ``(N, C)`` slice of an ``(R, N, C)`` stack (dense
    labels of the scores' shape, or class ids of one dimension fewer), on
    the scores' device. Inside ``torch.func.vmap`` the vmap rule
    (:func:`~metrics_tpu_torch.kernels._common.vmap_stack`) takes the whole
    batch, the axes of nested vmaps flattened into one, to one call of
    :func:`label_score_histograms_batched_cuda`."""
    if _is_batched(preds, labels):
        return vmap_stack(label_score_histograms_stacked, (preds, labels), num_bins, lo, hi)
    return label_score_histograms_batched_cuda(preds, labels, num_bins, lo, hi, device=preds.device)


def label_score_histograms(
    preds: Tensor, target: Tensor, num_bins: int, lo: float = 0.0, hi: float = 1.0
) -> Histograms:
    """Per-bin score counts split by label: the sketch update of the curves.

    Dispatches by the scores' device: a CUDA tensor to kernel B5, a CPU
    tensor to the plain version. Inside ``torch.func.vmap`` (the keyed
    path's per-row update, the pure bootstrap's resamples) the whole stack
    goes to the batched form in one call (:func:`label_score_histograms_stacked`).
    """
    if _is_batched(preds, target):
        return label_score_histograms_stacked(preds, target, num_bins, lo, hi)
    return label_score_histograms_cuda(preds, target, num_bins, lo, hi, device=preds.device)


def _label_score_histograms_onevsrest(
    preds: Tensor, labels: Tensor, num_bins: int, lo: float = 0.0, hi: float = 1.0
) -> Histograms:
    """:func:`label_score_histograms` of ``(N, C)`` class scores against the
    one-hot of ``(N,)`` integer class ids (one class against the rest),
    without building the one-hot on the card: kernel B5 takes the ids and
    counts a score as positive where its row's id equals its column. On the
    CPU the plain version builds the one-hot; inside ``torch.func.vmap`` the
    stack goes to the batched form, which takes the ids as they are.
    Equal to ``label_score_histograms(preds, to_onehot(labels.to(int32), C))``
    for every id, one outside ``[0, C)`` included (an all-negative row)."""
    if _is_batched(preds, labels):
        return label_score_histograms_stacked(preds, labels, num_bins, lo, hi)
    device = preds.device
    _check(preds, labels, False, num_bins, lo, hi, device)
    if device.type == "cpu":
        note_kernel_dispatch(_OP, "torch")
        return _onevsrest_torch(preds, labels, num_bins, lo, hi)
    require_capability(device)
    return _histograms_cuda(preds, labels, False, num_bins, lo, hi, device)


def binned_tp_fp_fn(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Binned TP/FP/FN counts: three ``(C, T)`` float32 count tensors of
    ``(N, C)`` scores against ascending ``(T,)`` thresholds."""
    t = (target == 1).unsqueeze(-1)
    p = preds.unsqueeze(-1) >= thresholds
    tps = torch.sum(t & p, dim=0).to(torch.float32)
    fps = torch.sum(~t & p, dim=0).to(torch.float32)
    fns = torch.sum(t & ~p, dim=0).to(torch.float32)
    return tps, fps, fns
