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
  to the plain version.

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
from typing import Tuple, Union

import torch

from metrics_tpu_torch.kernels._common import check_launch, kernel_function, note_kernel_dispatch, require_capability
from metrics_tpu_torch.utilities.data import Tensor, _is_batched, check_device, resolve_device

_OP = "label_score_histograms"
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
)
#: largest cell count 2 * C * num_bins the wrapper takes (num_bins reaches the kernel as a 32-bit int)
_MAX_CELLS = 2**31 - 1
#: the smallest normal float32; scores of smaller magnitude count as zero
_TINY = torch.finfo(torch.float32).tiny

Histograms = Tuple[Tensor, Tensor, Tensor]


def _bin_index(x: Tensor, num_bins: int, lo: float, hi: float) -> Tensor:
    """int64 bin of each float32 score; NaN goes to bin 0."""
    span = torch.tensor(hi - lo, dtype=torch.float32, device=x.device)
    raw = torch.floor((x - lo) / span * num_bins)
    return torch.where(torch.isnan(raw), 0.0, torch.clamp(raw, 0, num_bins - 1)).long()


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


def _check(preds: Tensor, target: Tensor, num_bins: int, lo: float, hi: float, device: torch.device) -> None:
    check_device(device, preds, target)
    if preds.ndim != 2 or preds.shape != target.shape:
        raise ValueError(f"{_OP} takes preds and target of one shape (N, C), got {tuple(preds.shape)} and"
                         f" {tuple(target.shape)}")
    if not (isinstance(num_bins, int) and num_bins >= 1 and 2 * preds.shape[1] * num_bins <= _MAX_CELLS):
        raise ValueError(f"{_OP} takes an integer num_bins >= 1 with 2 * C * num_bins <= {_MAX_CELLS}, got"
                         f" {num_bins} at C = {preds.shape[1]}")
    if not lo < hi:
        raise ValueError(f"{_OP} needs lo < hi, got {lo} and {hi}")


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
    device = resolve_device(device)
    _check(preds, target, num_bins, lo, hi, device)
    if device.type == "cpu":
        note_kernel_dispatch(_OP, "torch")
        return label_score_histograms_torch(preds, target, num_bins, lo, hi)
    if device.type != "cuda":
        raise ValueError(f"{_OP} runs on a CUDA or the CPU device, not on {device}")
    require_capability(device)
    x = preds.to(torch.float32).contiguous()
    t = (target if target.dtype == torch.int32 else (target == 1).to(torch.int32)).contiguous()
    n, c = x.shape
    cells = c * num_bins
    # one zero fill for both histograms and the clipped count
    out = torch.zeros(2 * cells + 1, dtype=torch.float32, device=device)
    if n and c:
        launch = kernel_function("label_score_histograms_launch", _ARGTYPES)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = launch(x.data_ptr(), t.data_ptr(), n, c, num_bins, lo, hi, hi - lo, out.data_ptr(), stream)
            check_launch(_OP, err)
        note_kernel_dispatch(_OP, "cuda")
    return out[:cells].view(c, num_bins), out[cells:2 * cells].view(c, num_bins), out[2 * cells]


def label_score_histograms(
    preds: Tensor, target: Tensor, num_bins: int, lo: float = 0.0, hi: float = 1.0
) -> Histograms:
    """Per-bin score counts split by label: the sketch update of the curves.

    Dispatches by the scores' device: a CUDA tensor to kernel B5, a CPU
    tensor to the plain version. Inside ``torch.func.vmap`` (the keyed
    path's per-row update) the plain version runs, since the kernel takes
    no batched tensor.
    """
    if _is_batched(preds, target):
        return label_score_histograms_torch(preds, target, num_bins, lo, hi)
    return label_score_histograms_cuda(preds, target, num_bins, lo, hi, device=preds.device)


def binned_tp_fp_fn(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Binned TP/FP/FN counts: three ``(C, T)`` float32 count tensors of
    ``(N, C)`` scores against ascending ``(T,)`` thresholds."""
    t = (target == 1).unsqueeze(-1)
    p = preds.unsqueeze(-1) >= thresholds
    tps = torch.sum(t & p, dim=0).to(torch.float32)
    fps = torch.sum(~t & p, dim=0).to(torch.float32)
    fns = torch.sum(t & ~p, dim=0).to(torch.float32)
    return tps, fps, fns
