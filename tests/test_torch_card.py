"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case here launches a kernel of ``metrics_tpu_torch/csrc`` and needs a
Hopper card: each carries the ``cuda`` marker and skips where there is none.
The file imports ``torch`` and the port only (no JAX, no ``metrics_tpu``),
so it runs on a machine that has no JAX:

    python -m pytest -m cuda tests/test_torch_card.py

Each kernel is held against its plain version (``<op>_torch``) on the same
CUDA tensors, exactly (B3's float sums too: the inputs are integer-valued),
and must count one launch per call; the keyed collection on the card must
equal the same collection on the CPU, directly and through the serving
queue (unstaged and staged, and staged with the flusher prefetching on
the staging lane), and the tenant ledger kept on the card must read what a
CPU twin's ledger reads. The compiled step's cases capture each kernel into
a CUDA graph and replay it against the plain version (launches counted per
replay), replay the compiled collection, keyed update and capacity mode
against the CPU, and capture while the serving flusher's thread works. The
retrieval cases hold the flat, padded and sketched modes on the card against
the CPU (the query reservoir and the hash bit for bit), replay the padded
compiled forward and the reservoir update, and count the keyed padded
update's merge launches. The observability cases run the compiled health guard
with no synchronizing call, split a sampled dispatch by CUDA events, hold the
memory ledger's bytes against the caching allocator's, and name the
collection's members in a ``torch.profiler`` trace. The durability cases
restore a checkpoint across devices, hold the compiled keyed update after
``grow``/``compact`` against eager (one capture a capacity), spill and fault
back under a held graph, and count the synchronizing calls of updates while
an async save flies. B5's batched entry is held against its plain version
at the keyed rows' and a bootstrap's stacks, at ragged ones, at every bin
edge and past 2^31 cells, captured and replayed, behind the vmap rule
(nested vmaps, unbatched labels) and on the keyed sketched curves.
"""
import numpy as np
import pytest
import torch

import metrics_tpu_torch as T
from metrics_tpu_torch.kernels import _common
from metrics_tpu_torch.kernels import binned_counts as bc
from metrics_tpu_torch.kernels import confusion_matrix as cm
from metrics_tpu_torch.kernels.binned_counts import (
    _label_score_histograms_onevsrest,
    label_score_histograms_cuda,
    label_score_histograms_torch,
)
from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_cuda, confmat_counts_torch
from metrics_tpu_torch.kernels.segment_scatter import (
    segment_merge_cuda,
    segment_merge_torch,
    segment_scatter_add_cuda,
    segment_scatter_add_torch,
    segment_scatter_max_cuda,
    segment_scatter_max_torch,
    segment_scatter_min_cuda,
    segment_scatter_min_torch,
)
from metrics_tpu_torch.kernels.stat_scores import stat_scores_counts_cuda, stat_scores_counts_torch

_TORCH = {"add": segment_scatter_add_torch, "max": segment_scatter_max_torch, "min": segment_scatter_min_torch}
_CUDA = {"add": segment_scatter_add_cuda, "max": segment_scatter_max_cuda, "min": segment_scatter_min_cuda}
_HIST = "label_score_histograms"
C = 10


@pytest.fixture
def cuda_device():
    if not _common.cuda_kernels_available():
        pytest.skip("needs a Hopper (sm_90) CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _zero_counters():
    _common.reset_dispatch_counters()
    yield
    _common.reset_dispatch_counters()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _assert_exact(got, want):
    """Equal values, NaN equal to NaN, and the same sign of zero (the sign
    bit of a NaN carries nothing and is not compared)."""
    want = np.asarray(want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got) & ~np.isnan(got), np.signbit(want) & ~np.isnan(want))


# -- B1 and B2 --------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(1, 1), (1023, 129), (1024, 1000), (4096, 2048)])
def test_stat_scores_kernel_matches_plain(cuda_device, n, c):
    rng = np.random.RandomState(c)
    preds, target = (torch.from_numpy(rng.randint(0, 2, (n, c)).astype(np.int32)).to(cuda_device) for _ in range(2))
    got = stat_scores_counts_cuda(preds, target)
    torch.cuda.synchronize()
    for g, w in zip(got, stat_scores_counts_torch(preds, target)):
        assert torch.equal(g, w)
    assert _common.launch_count("stat_scores_counts") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(1, 1, 1), (3, 1023, 129), (20, 1024, 1000), (70_000, 2, 3)])
def test_stat_scores_batched_kernel_matches_plain(cuda_device, b, n, c):
    """The batched form, one launch for the stack; 70,000 slices pass the
    grid's z limit of 65,535 and go in two groups."""
    rng = np.random.RandomState(b + c)
    preds, target = (torch.from_numpy(rng.randint(0, 3, (b, n, c)).astype(np.int32)).to(cuda_device)
                     for _ in range(2))
    got = stat_scores_counts_cuda(preds, target)
    torch.cuda.synchronize()
    for g, w in zip(got, stat_scores_counts_torch(preds, target)):
        assert g.shape == (b, c) and torch.equal(g, w)
    assert _common.launch_count("stat_scores_counts") == 1


def _dirty_pool(device, nbytes):
    """Leave ``nbytes`` of the caching allocator's pool filled with -1, so an
    output allocated without a fill next shows every cell a kernel fails to write."""
    torch.full((nbytes // 4,), -1, dtype=torch.int32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(4096, 1, 10), (70_000, 1, 3), (3, 5, 1000), (5, 0, 7), (1, 32, 300),
                                   (2000, 33, 10)])
def test_stat_scores_short_slices_match_plain(cuda_device, b, n, c):
    """B1's short-slice layout (one thread a (slice, column) pair, every
    cell stored): the keyed rows' (4096, 1, 10), 70,000 slices past the z
    form's 65,535, a mid shape, empty slices, the 32-row edge; and 2000
    slices of 33 rows, whose z grid is full without splitting a slice. The
    output comes from a pool of -1s, so a cell left unwritten shows."""
    rng = np.random.RandomState(b + n + c)
    preds, target = (torch.from_numpy(rng.randint(0, 3, (b, n, c)).astype(np.int32)).to(cuda_device)
                     for _ in range(2))
    _dirty_pool(cuda_device, 16 * b * c)
    got = stat_scores_counts_cuda(preds, target)
    torch.cuda.synchronize()
    for g, w in zip(got, stat_scores_counts_torch(preds, target)):
        assert g.shape == (b, c) and torch.equal(g, w)
    assert _common.launch_count("stat_scores_counts") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,dtype", [(1, 1000, torch.int64), (1024, 3, torch.int64), (1024, 64, torch.int32),
                                       (1024, 1000, torch.int64)])
def test_confmat_kernel_matches_plain(cuda_device, n, c, dtype):
    rng = np.random.RandomState(c)
    preds, target = (torch.from_numpy(rng.randint(0, c, n)).to(cuda_device, dtype) for _ in range(2))
    got = confmat_counts_cuda(preds, target, c)
    torch.cuda.synchronize()
    assert torch.equal(got, confmat_counts_torch(preds, target, c))
    assert _common.launch_count("confmat_counts") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(1, 1, 1), (8192, 1, 16), (256, 1, 16), (20, 1024, 1000), (3, 1023, 129),
                                   (30, 7, 20), (40, 3, 110), (40, 3, 111), (9, 50, 200), (5, 20, 241),
                                   (5, 20, 242), (7, 0, 5)])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_confmat_batched_kernel_matches_plain(cuda_device, b, n, c, dtype):
    """B2's batched entry at the keyed rows' shapes (8,192 and 256
    length-1 rows of 16 classes) and the bootstrap's (20 children of 1,024
    pairs over 1,000 classes), one launch for the stack; on both sides of
    the 48 KB line (C = 110, 111) and of the shared route's opt-in limit
    (C = 241, 242); odd C, whose blocks start unaligned; empty rows. Labels
    in [-1, C], so out-of-range pairs are dropped; the output comes from a
    pool of -1s, so a cell left unwritten shows."""
    rng = np.random.RandomState(b + c)
    preds, target = (torch.from_numpy(rng.randint(-1, c + 1, (b, n))).to(cuda_device, dtype) for _ in range(2))
    _dirty_pool(cuda_device, 4 * b * c * c)
    got = cm.confmat_counts_batched_cuda(preds, target, c)
    torch.cuda.synchronize()
    assert got.shape == (b, c, c) and torch.equal(got, cm.confmat_counts_batched_torch(preds, target, c))
    assert _common.launch_count("confmat_counts") == 1


@pytest.mark.cuda
def test_confmat_batched_kernel_past_2_31_cells(cuda_device):
    """One stack of 2049 x 1024 x 1024 cells, past 2^31: one launch at
    int64 offsets, compared slice by slice."""
    b, c = 2049, 1024
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    preds, target = (torch.randint(-1, c + 1, (b, 1), generator=gen, device=cuda_device) for _ in range(2))
    got = cm.confmat_counts_batched_cuda(preds, target, c)
    torch.cuda.synchronize()
    assert got.shape == (b, c, c) and _common.launch_count("confmat_counts") == 1
    for i in range(b):
        assert torch.equal(got[i], confmat_counts_torch(preds[i], target[i], c)), i
    keep = ((preds >= 0) & (preds < c) & (target >= 0) & (target < c)).sum()
    assert int(got.sum(dtype=torch.int64)) == int(keep)


@pytest.mark.cuda
def test_b1_b2_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    p = torch.zeros(8, 4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        stat_scores_counts_cuda(p, p)
    q = torch.zeros(4, 8, dtype=torch.int32, device=cuda_device).t()
    with pytest.raises(ValueError):
        stat_scores_counts_cuda(q, q)
    with pytest.raises(TypeError):
        confmat_counts_cuda(p[:, 0].contiguous(), p[:, 0].int().contiguous(), 3)
    assert _common.launch_count("stat_scores_counts") == 0


# -- B3 and B4 --------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("r,s,d", [(4096, 10_000, 40), (4096, 10_000, 8), (4096, 10_000, 6), (4096, 10_000, 4),
                                   (4096, 10_000, 3), (4096, 10_000, 2), (4096, 10_000, 1), (1, 1, 1),
                                   (4099, 100_000, 3), (300, 64, 16)])
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("ids_dtype", [torch.int64, torch.int32])
def test_segment_scatter_kernel_matches_plain(cuda_device, op, r, s, d, offset, ids_dtype):
    """Bit for bit the plain version, with rows that start 0, 4 or 8 bytes
    into their buffer (float4, scalar or float2 access for B3 where D
    allows) and int64 or int32 ids, invalid ones among them."""
    rng = np.random.RandomState(r + 10 * d + offset)
    buf = torch.from_numpy(rng.randint(-3, 4, r * d + offset).astype(np.float32)).to(cuda_device)
    rows = buf[offset:offset + r * d].view(r, d)
    ids = torch.from_numpy(rng.randint(-1, s + 8, r)).to(ids_dtype).to(cuda_device)
    got = _CUDA[op](rows, ids, s)
    torch.cuda.synchronize()
    for g, w in zip(got, _TORCH[op](rows, ids, s)):
        _assert_exact(g.cpu().numpy(), w.cpu().numpy())
    assert _common.launch_count(f"segment_scatter_{op}") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["max", "min"])
def test_extremal_kernel_nan_and_signed_zero(cuda_device, op):
    rows = torch.tensor([[np.nan], [1.0], [-0.0], [0.0], [0.0], [-0.0], [np.inf], [-np.inf]], device=cuda_device)
    ids = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3], device=cuda_device)
    got, _ = _CUDA[op](rows, ids, 5)
    want, _ = _TORCH[op](rows, ids, 5)
    torch.cuda.synchronize()
    _assert_exact(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_b3_b4_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    ids = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        segment_scatter_add_cuda(torch.zeros(4, 2, dtype=torch.float64, device=cuda_device), ids, 3)
    with pytest.raises(ValueError):
        segment_scatter_max_cuda(torch.zeros(2, 4, device=cuda_device).t(), ids, 3)
    assert _common.launch_count("segment_scatter_add") == 0


# -- the merge ----------------------------------------------------------------------


def _b_merge_inputs(dev, gen, dtype, r=4096, s=10_000):
    """The merge's inputs as the keyed cell's update gives them: ids (invalid
    ones among them), Accuracy's rows as the columns of one (R, 5) tensor
    (tp, fp, tn, fn, mode_code), the macro bundle's (R, 4, 10) output of B1's
    batched entry, the defaults (non-zero here, 0-d and (10,)) and the
    eleven (S, ...) states."""
    ids = torch.randint(-2, s + 8, (r,), generator=gen, device=dev)
    acc = torch.randint(-1, 3, (r, 5), generator=gen, device=dev).to(dtype)
    macro = torch.randint(0, 3, (r, 4, 10), generator=gen, device=dev).to(dtype)
    d0, d10 = torch.ones((), dtype=dtype, device=dev), torch.ones(10, dtype=dtype, device=dev)
    states = [torch.randint(-5, 6, (s,) + shape, generator=gen, device=dev).to(dtype)
              for shape in [()] * 7 + [(10,)] * 4]
    return (ids, acc, macro, d0, d10, *states)


def _b_merge_leaves(ids, acc, macro, d0, d10, *states):
    """The keyed cell's eleven leaves: Accuracy's four sums read in place at
    row stride 5, ``correct`` and ``total`` as its broadcast default (stride
    0), its ``mode_code`` max, and the macro bundle's four (R, 10) sums read
    in place at row stride 40."""
    r = ids.shape[0]
    rows = [acc[:, k] for k in range(4)] + [d0.expand(r), d0.expand(r), acc[:, 4]] + [macro[:, k] for k in range(4)]
    ops = ["sum"] * 6 + ["max"] + ["sum"] * 4
    defaults = [d0] * 7 + [d10] * 4
    return [(x, state, d, op) for x, state, d, op in zip(rows, states, defaults, ops)]


def _flat_merge(fn):
    """``fn`` (the merge's kernel or plain version) over :func:`_b_merge_inputs`,
    its outputs as one flat tuple."""
    def call(*inputs):
        outs, counts, invalid = fn(_b_merge_leaves(*inputs), inputs[0], inputs[5].shape[0])
        return (*outs, counts, invalid)
    return call


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("ids_dtype", [torch.int64, torch.int32])
def test_merge_kernel_matches_plain_at_the_keyed_shapes(cuda_device, dtype, ids_dtype):
    """The keyed cell's eleven leaves at R = 4096, S = 10,000, their rows read
    in place (strided and broadcast), non-zero defaults, NaN and signed zeros
    among the float max leaf's rows: bit for bit the plain version, in one
    launch and no B3 or B4."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    inputs = list(_b_merge_inputs(cuda_device, gen, dtype))
    inputs[0] = inputs[0].to(ids_dtype)
    if dtype == torch.float32:
        inputs[1][:3, 4] = torch.tensor([float("nan"), -0.0, 0.0], device=cuda_device)
    got = _flat_merge(lambda leaves, ids, s: segment_merge_cuda(leaves, ids, s, device=cuda_device))(*inputs)
    torch.cuda.synchronize()
    want = _flat_merge(segment_merge_torch)(*inputs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_exact(g.cpu().numpy(), w.cpu().numpy())
    assert int(got[-2].sum()) + int(got[-1]) == 4096
    assert _common.launch_count("segment_merge") == 1
    assert all(_common.launch_count(f"segment_scatter_{op}") == 0 for op in ("add", "max", "min"))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("d", [40, 10, 6, 3, 1])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_merge_kernel_vector_widths_match_plain(cuda_device, op, dtype, d, offset):
    """Rows, and the default, 0, 4 or 8 bytes into their buffers (V = 4, 1 or
    2 where D allows): bit for bit the plain version, with a ragged R."""
    rng = np.random.RandomState(d + 7 * offset)
    r, s = 4099, 1000
    buf = torch.from_numpy(rng.randint(-3, 4, r * d + offset).astype(np.float32)).to(dtype).to(cuda_device)
    rows = buf[offset:offset + r * d].view(r, d)
    default = torch.from_numpy(rng.randint(-2, 3, d + offset).astype(np.float32)).to(dtype).to(cuda_device)
    default = default[offset:]
    state = torch.from_numpy(rng.randint(-9, 10, (s, d)).astype(np.float32)).to(dtype).to(cuda_device)
    ids = torch.from_numpy(rng.randint(-1, s + 3, r)).to(cuda_device)
    leaves = [(rows, state, default, op)]
    got = segment_merge_cuda(leaves, ids, s, device=cuda_device)
    torch.cuda.synchronize()
    want = segment_merge_torch(leaves, ids, s)
    _assert_exact(got[0][0].cpu().numpy(), want[0][0].cpu().numpy())
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert _common.launch_count("segment_merge") == 1


@pytest.mark.cuda
def test_merge_kernel_on_a_keyed_regression_bundle(cuda_device):
    """Float32 sums of real-valued rows (squared and absolute errors) over a
    large accumulated state, with an int32 count: the count exactly, the sums
    as the plain version's ``state + sum`` to float32 rounding."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    r, s = 4096, 10_000
    err = torch.randn(r, generator=gen, device=cuda_device)
    ids = torch.randint(-1, s + 1, (r,), generator=gen, device=cuda_device)
    big = 1e6 * torch.rand(s, generator=gen, device=cuda_device)
    zero_f, zero_i = torch.zeros((), device=cuda_device), torch.zeros((), dtype=torch.int32, device=cuda_device)
    leaves = [(err * err, big, zero_f, "sum"), (err.abs(), big.clone(), zero_f, "sum"),
              (torch.ones((), dtype=torch.int32, device=cuda_device).expand(r),
               torch.randint(0, 9, (s,), generator=gen, device=cuda_device, dtype=torch.int32), zero_i, "sum")]
    got = segment_merge_cuda(leaves, ids, s, device=cuda_device)
    torch.cuda.synchronize()
    want = segment_merge_torch(leaves, ids, s)
    for g, w in zip(got[0][:2], want[0][:2]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)
    assert torch.equal(got[0][2], want[0][2]) and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert _common.launch_count("segment_merge") == 1


@pytest.mark.cuda
def test_the_keyed_collection_launches_one_merge_an_update_eager_and_compiled(cuda_device):
    """Eager and compiled, the keyed collection's update launches the merge
    exactly once (each replay counts its one launch) and B3 and B4 never;
    both end in the same states."""
    n = 50
    cohorts = _keyed_cohorts(12, [256] * 4, n)
    eager = T.MultiTenantCollection(_members(device=cuda_device), n, validate_ids=False, device=cuda_device)
    compiled = T.MultiTenantCollection(_members(device=cuda_device), n, validate_ids=False, device=cuda_device)
    compiled.warmup(*(_t(x).to(cuda_device) for x in cohorts[0]))
    for obj in (eager, compiled):
        _common.reset_dispatch_counters()
        for c in cohorts:
            obj.update(*(_t(x).to(cuda_device) for x in c))
        torch.cuda.synchronize()
        assert _common.launch_count("segment_merge") == len(cohorts)
        assert all(_common.launch_count(f"segment_scatter_{op}") == 0 for op in ("add", "max", "min"))
    for owner, km in eager._keyed.items():
        for name, value in km._get_states().items():
            assert torch.equal(getattr(compiled._keyed[owner], name), value), name


# -- B5 ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,b", [(1024, 1000, 2048), (10_000, 1, 2048), (7, 3, 4096), (1023, 3, 4096),
                                   (300, 7, 2048), (64, 1001, 2048), (1, 1, 2048), (100_000, 10, 2048),
                                   (16, 4, 65536)])
def test_histogram_kernel_matches_plain(cuda_device, n, c, b):
    gen = torch.Generator(device=cuda_device).manual_seed(n + c)
    preds = torch.rand((n, c), generator=gen, device=cuda_device)
    target = torch.randint(0, 2, (n, c), generator=gen, device=cuda_device, dtype=torch.int32)
    got = label_score_histograms_cuda(preds, target, b, device=cuda_device)
    torch.cuda.synchronize()
    for g, w in zip(got, label_score_histograms_torch(preds, target, b)):
        assert torch.equal(g, w)
    assert _common.launch_count(_HIST) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,b", [(1024, 1000, 2048), (64, 1001, 2048), (100_000, 10, 2048), (16, 4, 65536)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_histogram_kernel_with_class_ids_matches_plain(cuda_device, n, c, b, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n + c)
    preds = torch.rand((n, c), generator=gen, device=cuda_device)
    ids = torch.randint(-1, c + 1, (n,), generator=gen, device=cuda_device).to(dtype)
    got = _label_score_histograms_onevsrest(preds, ids, b)
    torch.cuda.synchronize()
    for g, w in zip(got, bc._onevsrest_torch(preds, ids, b)):
        assert torch.equal(g, w)
    assert _common.launch_count(_HIST) == 1


# -- the keyed collection ------------------------------------------------------------


def _members(**device):
    kw = dict(average="macro", num_classes=C, **device)
    return {"Accuracy": T.Accuracy(**device), "Precision": T.Precision(**kw), "Recall": T.Recall(**kw),
            "F1": T.F1(**kw)}


@pytest.mark.cuda
def test_keyed_collection_on_the_card_matches_the_cpu(cuda_device):
    rng = np.random.RandomState(10)
    card = T.MultiTenantCollection(_members(device=cuda_device), 50, validate_ids=False, device=cuda_device)
    host = T.MultiTenantCollection(_members(device="cpu"), 50, validate_ids=False, device="cpu")
    for _ in range(3):
        ids = rng.randint(-1, 51, 256)
        logits = rng.rand(256, C).astype(np.float32)
        preds, target = logits / logits.sum(-1, keepdims=True), rng.randint(0, C, 256)
        card.update(_t(ids).to(cuda_device), _t(preds).to(cuda_device), _t(target).to(cuda_device))
        host.update(_t(ids), _t(preds), _t(target))
    # one merge an update for both bundles' eleven leaves, no B3, no B4
    assert _common.launch_count("segment_merge") == 3
    assert _common.launch_count("segment_scatter_add") == 0 and _common.launch_count("segment_scatter_max") == 0
    # the macro bundle's rows: one B1 launch an update, over the (256, 1, C) stack
    assert _common.launch_count("stat_scores_counts") == 3
    for owner, km in host._keyed.items():
        for name, value in km._get_states().items():
            assert torch.equal(getattr(card._keyed[owner], name).cpu(), value)
    got, want = card.compute(), host.compute()
    for name in want:
        torch.testing.assert_close(got[name].cpu(), want[name], rtol=1e-6, atol=1e-7, equal_nan=True)


@pytest.mark.cuda
def test_the_batched_rows_on_the_card_equal_the_vmap_route(cuda_device, monkeypatch):
    """The benchmark cell's collection (Accuracy, macro P/R/F1; 10,000 tenants,
    4,096-row cohorts, the last padded with all-zero rows of id -1, tie rows
    in each) on the card: the batched-rows form gives the vmap route's
    states exactly, with one launch of B1's batched entry over the
    ``(4096, 1, C)`` stack an update for the macro bundle, as the vmap route
    makes."""
    from metrics_tpu_torch.kernels import stat_scores as st
    from metrics_tpu_torch.utilities import stacked

    rng = np.random.RandomState(21)
    cohorts = []
    for k in range(4):
        logits = rng.rand(4096, C).astype(np.float32)
        preds, target = logits / logits.sum(-1, keepdims=True), rng.randint(0, C, 4096)
        ids = rng.randint(0, 10_000, 4096)
        preds[:8] = 1.0 / C
        if k == 3:
            preds[3000:], target[3000:], ids[3000:] = 0.0, 0, -1
        cohorts.append(tuple(_t(x).to(cuda_device) for x in (ids, preds, target)))
    batched = T.MultiTenantCollection(_members(device=cuda_device), 10_000, validate_ids=False, device=cuda_device)
    vmapped = T.MultiTenantCollection(_members(device=cuda_device), 10_000, validate_ids=False, device=cuda_device)
    vmapped.build()
    for km in vmapped._keyed.values():
        km._child._row_states = lambda *a, **k: None
    shapes, taken = [], []
    wrapper, vmap_rows = st.stat_scores_counts_cuda, stacked._vmapped_rows
    monkeypatch.setattr(st, "stat_scores_counts_cuda",
                        lambda p, t, device="cuda": shapes.append(tuple(p.shape)) or wrapper(p, t, device=device))
    monkeypatch.setattr(stacked, "_vmapped_rows", lambda metric, *a: taken.append(metric) or vmap_rows(metric, *a))
    for cohort in cohorts:
        batched.update(*cohort)
    assert not taken and shapes == [(4096, 1, C)] * len(cohorts)
    assert _common.launch_count("stat_scores_counts") == len(cohorts)
    for cohort in cohorts:
        vmapped.update(*cohort)
    assert len(taken) == 2 * len(cohorts) and shapes == [(4096, 1, C)] * (2 * len(cohorts))
    assert _common.launch_count("stat_scores_counts") == 2 * len(cohorts)
    for owner, km in vmapped._keyed.items():
        for name, value in km._get_states().items():
            got = getattr(batched._keyed[owner], name)
            assert got.dtype == value.dtype and torch.equal(got, value), (owner, name)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3])
def test_select_topk_keeps_the_lower_class_among_ties_on_the_card(cuda_device, k):
    """The card's top k of tied probabilities are the lowest classes among the
    tied, as on the CPU and in the JAX package's ``lax.top_k``: rows of equal
    values, all-zero rows, a tie at the k-th place, a NaN; on a batch, on
    wide rows and on each row under ``torch.func.vmap``."""
    from metrics_tpu_torch.utilities.data import select_topk

    probs = np.array([[0.25] * 4, [0.0] * 4, [0.1, 0.3, 0.3, 0.3], [0.4, 0.2, 0.2, 0.2],
                      [np.nan, 0.1, 0.2, 0.3]], dtype=np.float32)
    want = {2: [[1, 1, 0, 0], [1, 1, 0, 0], [0, 1, 1, 0], [1, 1, 0, 0], [1, 0, 0, 1]],
            3: [[1, 1, 1, 0], [1, 1, 1, 0], [0, 1, 1, 1], [1, 1, 1, 0], [1, 0, 1, 1]]}[k]
    dev = _t(probs).to(cuda_device)
    assert select_topk(dev, k).cpu().tolist() == want
    vmapped = torch.func.vmap(lambda row: select_topk(row, k))(dev.unsqueeze(1)).squeeze(1)
    assert vmapped.cpu().tolist() == want
    wide = torch.zeros((4096, 1000), device=cuda_device)
    wide[1::2, 500:] = 1.0
    got = select_topk(wide, k).cpu()
    assert torch.equal(got[0::2], torch.zeros(2048, 1000, dtype=torch.int32).index_fill_(1, torch.arange(k), 1))
    assert torch.equal(got[1::2], torch.zeros(2048, 1000, dtype=torch.int32).index_fill_(1, torch.arange(500, 500 + k), 1))


# -- the serving plane -----------------------------------------------------------------


def _keyed_cohorts(seed, cohorts, n):
    rng = np.random.RandomState(seed)
    out = []
    for rows in cohorts:
        logits = rng.rand(rows, C).astype(np.float32)
        out.append((rng.randint(0, n, rows), logits / logits.sum(-1, keepdims=True), rng.randint(0, C, rows)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("staging", [False, True])
def test_the_queue_on_the_card_matches_the_cpu(cuda_device, staging):
    """Cohorts through an ``AdmissionQueue`` over a card collection and over
    a CPU one: ledgers and stacked states equal, the pad rows counted as
    invalid ids, the merge launched once per flush. Staged, the twins
    are copied on the queue's side stream from pinned slots."""
    from metrics_tpu_torch.serving import AdmissionQueue

    n, cohorts = 40, [100, 256, 77]
    card = T.MultiTenantCollection(_members(device=cuda_device), n, validate_ids=False, device=cuda_device)
    host = T.MultiTenantCollection(_members(device="cpu"), n, validate_ids=False, device="cpu")
    seen = []
    queues = [AdmissionQueue(m.update, max_batch=256, pad_to_bucket=True, staging=staging, start=False)
              for m in (card, host)]
    real_update = card.update

    def spy(ids, *cols):
        seen.append([getattr(c, "device_tensor", None) for c in (ids, *cols)])
        real_update(ids, *cols)

    queues[0]._target = spy
    for ids, preds, target in _keyed_cohorts(3, cohorts, n):
        for q in queues:
            q.submit_many(ids, preds, target)
            q.flush()
    torch.cuda.synchronize()
    ledgers = [q.stats() for q in queues]
    for ledger in ledgers:
        for k in ("stage_seconds", "overlap_seconds", "overlap_fraction"):
            ledger["staging"].pop(k, None)
    assert ledgers[0] == ledgers[1] and ledgers[0]["last_error"] is None
    assert all(t.device.type == "cuda" for twins in seen for t in twins)
    if staging:
        assert queues[0]._copy_stream is not None and queues[0]._slots.pin
        assert all(s is None or s.tensors[0].is_pinned() for s in queues[0]._slots._slots)
    assert _common.launch_count("segment_merge") == len(cohorts)
    assert _common.launch_count("segment_scatter_add") == 0 and _common.launch_count("segment_scatter_max") == 0
    assert _common.launch_count("stat_scores_counts") == len(cohorts)
    for owner, km in host._keyed.items():
        for name, value in km._get_states().items():
            assert torch.equal(getattr(card._keyed[owner], name).cpu(), value)
    reports = [m.tenant_report() for m in (card, host)]
    for key in ("rows_routed", "occupancy", "top_traffic", "invalid_tenant_ids"):
        assert reports[0][key] == reports[1][key]
    assert reports[0]["invalid_tenant_ids"] == (128 - 100) + (128 - 77)
    for q in queues:
        q.close()


@pytest.mark.cuda
def test_the_queue_prefetches_on_the_card_with_its_flusher_running(cuda_device):
    """Staged, with the flusher thread running and two full cohorts per
    submit: the flusher dispatches one while the staging lane fills and
    copies the next on the side stream, and the dispatch waits on its copy
    event. Cohorts must be prefetched, and the stacked states must equal a
    CPU collection's after the same rows exactly."""
    from metrics_tpu_torch.serving import AdmissionQueue

    n, batch = 40, 128
    card = T.MultiTenantCollection(_members(device=cuda_device), n, validate_ids=False, device=cuda_device)
    host = T.MultiTenantCollection(_members(device="cpu"), n, validate_ids=False, device="cpu")
    q = AdmissionQueue(card.update, max_batch=batch, max_delay_ms=1000.0, staging=True)
    try:
        for ids, preds, target in _keyed_cohorts(5, [2 * batch] * 12, n):
            q.submit_many(ids, preds, target)
            host.update(_t(ids), _t(preds), _t(target))
        assert q.drain(timeout=60)
        stats = q.stats()
    finally:
        q.close(timeout=10)
    torch.cuda.synchronize()
    assert stats["last_error"] is None and stats["dispatched"] == 24 * batch and stats["shed"] == 0
    assert stats["staging"]["prefetched_cohorts"] > 0
    for owner, km in host._keyed.items():
        for name, value in km._get_states().items():
            assert torch.equal(getattr(card._keyed[owner], name).cpu(), value)


@pytest.mark.cuda
def test_the_device_ledger_equals_the_host_ledger(cuda_device):
    """Ids on the card feed the ledger on the card from the kernels'
    per-tenant counts (no host read); it must report what a CPU twin's
    ledger reports for the same batches."""
    rng = np.random.RandomState(4)
    card = T.KeyedMetric(T.Accuracy(device=cuda_device), 30, validate_ids=False, device=cuda_device)
    host = T.KeyedMetric(T.Accuracy(device="cpu"), 30, validate_ids=False, device="cpu")
    for step in range(5):
        ids, preds = rng.randint(-2, 33, 200), rng.rand(200).astype(np.float32)
        target = (rng.rand(200) < preds).astype(np.int64)
        card.update(_t(ids).to(cuda_device, torch.int32 if step % 2 else torch.int64), _t(preds).to(cuda_device),
                    _t(target).to(cuda_device))
        host.update(_t(ids), _t(preds), _t(target))
    assert card._traffic.rows.device.type == "cuda" and host._traffic.rows.device.type == "cpu"
    (cr, cs), (hr, hs) = card._traffic.arrays(), host._traffic.arrays()
    assert np.array_equal(cr, hr) and np.array_equal(np.isnan(cs), np.isnan(hs))
    reports = [m.tenant_report() for m in (card, host)]
    for key in ("rows_routed", "occupancy", "top_traffic", "invalid_tenant_ids", "invalid_rate"):
        assert reports[0][key] == reports[1][key]


# -- the compiled step: CUDA graphs -------------------------------------------------


def _graph_cases(dev):
    """``(name, op, make inputs, kernel, plain, tolerance)`` of every kernel
    at a path's shape, B3/B4 and B5's add mode (cooperative launches) among them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    def ids_rows(d):
        return lambda: (torch.randint(-1, 10_001, (4096,), generator=gen, device=dev),
                        torch.randint(0, 2, (4096, d), generator=gen, device=dev).float())

    def binary(n, c):
        return lambda: (torch.randint(0, 2, (n, c), generator=gen, device=dev, dtype=torch.int32),
                        torch.randint(0, 2, (n, c), generator=gen, device=dev, dtype=torch.int32))

    def labels():
        return (torch.randint(0, 1000, (1024,), generator=gen, device=dev),
                torch.randint(0, 1000, (1024,), generator=gen, device=dev))

    def scores_ids():
        return (torch.rand((1024, 1000), generator=gen, device=dev),
                torch.randint(0, 1000, (1024,), generator=gen, device=dev))

    def stream():
        s = torch.rand((10_000, 1), generator=gen, device=dev)
        return s, (torch.rand((10_000, 1), generator=gen, device=dev) < s).to(torch.int32)

    def dense():
        return (torch.rand((1024, 1000), generator=gen, device=dev),
                torch.randint(0, 2, (1024, 1000), generator=gen, device=dev, dtype=torch.int32))

    return [
        ("B1", "stat_scores_counts", binary(1024, 1000), lambda p, t: stat_scores_counts_cuda(p, t, device=dev),
         stat_scores_counts_torch),
        ("B2", "confmat_counts", labels, lambda p, t: (confmat_counts_cuda(p, t, 1000, device=dev),),
         lambda p, t: (confmat_counts_torch(p, t, 1000),)),
        ("B3", "segment_scatter_add", ids_rows(40), lambda i, r: segment_scatter_add_cuda(r, i, 10_000, device=dev),
         lambda i, r: segment_scatter_add_torch(r, i, 10_000)),
        ("B4 max", "segment_scatter_max", ids_rows(1),
         lambda i, r: segment_scatter_max_cuda(r, i, 10_000, device=dev),
         lambda i, r: segment_scatter_max_torch(r, i, 10_000)),
        ("B4 min", "segment_scatter_min", ids_rows(1),
         lambda i, r: segment_scatter_min_cuda(r, i, 10_000, device=dev),
         lambda i, r: segment_scatter_min_torch(r, i, 10_000)),
        ("merge", "segment_merge", lambda: _b_merge_inputs(dev, gen, torch.int32),
         _flat_merge(lambda leaves, ids, s: segment_merge_cuda(leaves, ids, s, device=dev)),
         _flat_merge(segment_merge_torch)),
        ("B5 class ids", _HIST, scores_ids, lambda s, i: _label_score_histograms_onevsrest(s, i, 2048),
         lambda s, i: bc._onevsrest_torch(s, i, 2048)),
        ("B5 dense", _HIST, dense, lambda s, t: label_score_histograms_cuda(s, t, 2048, device=dev),
         lambda s, t: label_score_histograms_torch(s, t, 2048)),
        ("B5 add mode", _HIST, stream, lambda s, t: label_score_histograms_cuda(s, t, 2048, device=dev),
         lambda s, t: label_score_histograms_torch(s, t, 2048)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(9), ids=["B1", "B2", "B3", "B4 max", "B4 min", "merge", "B5 class ids",
                                               "B5 dense", "B5 add mode"])
def test_a_captured_then_replayed_launch_equals_the_plain_version(cuda_device, case):
    """Each kernel captured once into a CUDA graph (thread-local capture, as
    the compiled step captures) and replayed on fresh inputs copied into its
    input buffers: every replay equals the plain version exactly (B3's rows
    are integer-valued), and each replay counts one launch (the capture's
    tally), the capture none."""
    _capture_and_replay(*_graph_cases(cuda_device)[case])


def _batched_graph_cases(dev):
    """The batched forms of B1 and B2 at the keyed rows' shapes, B2's global
    route (its memset is captured too) and a shared route past 48 KB (the
    opt-in is set while the capture runs)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)

    def binary(b, n, c):
        return lambda: tuple(torch.randint(0, 2, (b, n, c), generator=gen, device=dev, dtype=torch.int32)
                             for _ in range(2))

    def labels(b, n, c):
        return lambda: tuple(torch.randint(-1, c + 1, (b, n), generator=gen, device=dev) for _ in range(2))

    def b2(c):
        return (lambda p, t: (cm.confmat_counts_batched_cuda(p, t, c, device=dev),),
                lambda p, t: (cm.confmat_counts_batched_torch(p, t, c),))

    def scores(r, n, c, dense):
        def make():
            s = torch.rand((r, n, c), generator=gen, device=dev)
            if dense:
                return s, torch.randint(0, 2, (r, n, c), generator=gen, device=dev, dtype=torch.int32)
            return s, torch.randint(-1, c + 1, (r, n), generator=gen, device=dev)
        return make

    def b5(b):
        return (lambda s, t: bc.label_score_histograms_batched_cuda(s, t, b, device=dev),
                lambda s, t: bc.label_score_histograms_batched_torch(s, t, b))

    return [
        ("B1 short slices", "stat_scores_counts", binary(4096, 1, 10),
         lambda p, t: stat_scores_counts_cuda(p, t, device=dev), stat_scores_counts_torch),
        ("B2 batched shared", "confmat_counts", labels(8192, 1, 16), *b2(16)),
        ("B2 batched opt-in", "confmat_counts", labels(9, 50, 200), *b2(200)),
        ("B2 batched global", "confmat_counts", labels(20, 1024, 1000), *b2(1000)),
        ("B5 batched keyed rows", _HIST, scores(4096, 1, 1, True), *b5(2048)),
        ("B5 batched class ids", _HIST, scores(4096, 1, 10, False), *b5(2048)),
        ("B5 batched tiles", _HIST, scores(20, 1024, 1000, False), *b5(2048)),
        ("B5 batched global", _HIST, scores(3, 16, 4, True), *b5(65536)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(8), ids=["B1 short slices", "B2 batched shared", "B2 batched opt-in",
                                               "B2 batched global", "B5 batched keyed rows", "B5 batched class ids",
                                               "B5 batched tiles", "B5 batched global"])
def test_a_captured_batched_launch_equals_the_plain_version(cuda_device, case):
    """The batched entries inside a capture, as the compiled keyed update
    takes them: each replay equals the plain version and counts one launch."""
    _capture_and_replay(*_batched_graph_cases(cuda_device)[case])


def _capture_and_replay(name, op, make, kernel, plain):
    static = [x.clone() for x in make()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(*static)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    graph = torch.cuda.CUDAGraph()
    with _common.capture_tally() as tally, torch.cuda.graph(graph, capture_error_mode="thread_local"):
        captured = kernel(*static)
    assert tally == {op: 1} and _common.launch_count(op) == 0
    for replay in range(1, 3):
        fresh = make()
        for buf, x in zip(static, fresh):
            buf.copy_(x)
        graph.replay()
        _common.note_replay(tally)
        torch.cuda.synchronize()
        for g, w in zip(captured, plain(*fresh)):
            assert g.dtype == w.dtype and torch.equal(g, w), name
        assert _common.launch_count(op) == replay


def _compiled_members(device):
    kw = dict(average="macro", num_classes=C, device=device)
    return {"Accuracy": T.Accuracy(device=device), "Precision": T.Precision(**kw), "Recall": T.Recall(**kw),
            "ConfusionMatrix": T.ConfusionMatrix(num_classes=C, device=device)}


def _softmax_batches(seed, count, n=256):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        logits = rng.rand(n, C).astype(np.float32)
        out.append((logits / logits.sum(-1, keepdims=True), rng.randint(0, C, n)))
    return out


@pytest.mark.cuda
def test_the_compiled_collection_replays_in_place_and_counts_its_launches(cuda_device):
    """``jit_forward`` + ``warmup`` on the card: each forward one replay (B1
    and B2 counted once per replay), the state tensors written where they
    lie, every value equal to the CPU's, and a ``reset()`` copied into the
    graph's tensors without a new capture."""
    card = T.MetricCollection(_compiled_members(cuda_device)).jit_forward()
    host = T.MetricCollection(_compiled_members("cpu"))
    batches = _softmax_batches(3, 6)
    card.warmup(_t(batches[0][0]).to(cuda_device), _t(batches[0][1]).to(cuda_device))
    ptr = card["Precision"].tp.data_ptr()
    _common.reset_dispatch_counters()
    for i, (p, t) in enumerate(batches):
        if i == 3:
            card.reset()
            host.reset()
        got = card(_t(p).to(cuda_device), _t(t).to(cuda_device))
        want = host(_t(p), _t(t))
        for name, value in want.items():
            assert torch.allclose(got[name].cpu().float(), value.float(), atol=1e-6, rtol=0), name
    torch.cuda.synchronize()
    assert _common.launch_count("stat_scores_counts") == 6 and _common.launch_count("confmat_counts") == 6
    assert card._jit_forward_fn.cache_info() == {"entries": 1, "hits": 6, "misses": 1}
    assert card["Precision"].tp.data_ptr() == ptr and card["Recall"].tp is card["Precision"].tp
    for name, value in host.compute().items():
        assert torch.allclose(card.compute()[name].cpu().float(), value.float(), atol=1e-6, rtol=0), name


@pytest.mark.cuda
def test_a_graph_captured_while_a_serving_flusher_runs(cuda_device):
    """The capture's thread-local mode: while the admission queue's flusher
    thread dispatches keyed updates on the card, this thread captures (and
    replays) the compiled collection; neither fails, and both states equal
    the CPU's after the same rows."""
    from metrics_tpu_torch.serving import AdmissionQueue

    n, batch = 40, 128
    keyed = T.MultiTenantCollection(_members(device=cuda_device), n, validate_ids=False, device=cuda_device)
    keyed_host = T.MultiTenantCollection(_members(device="cpu"), n, validate_ids=False, device="cpu")
    col = T.MetricCollection(_compiled_members(cuda_device)).jit_forward()
    col_host = T.MetricCollection(_compiled_members("cpu"))
    batches = _softmax_batches(4, 8)
    q = AdmissionQueue(keyed.update, max_batch=batch, max_delay_ms=1.0)
    try:
        for k, (ids, preds, target) in enumerate(_keyed_cohorts(6, [batch] * 16, n)):
            q.submit_many(ids, preds, target)
            keyed_host.update(_t(ids), _t(preds), _t(target))
            if k < len(batches):
                p, t = batches[k]
                if k in (0, 5):  # a capture while the flusher works (batch 5 is one row short)
                    p, t = (p, t) if k == 0 else (p[:-1], t[:-1])
                    col.warmup(_t(p).to(cuda_device), _t(t).to(cuda_device))
                col(_t(p).to(cuda_device), _t(t).to(cuda_device))
                col_host(_t(p), _t(t))
        assert q.drain(timeout=60)
        stats = q.stats()
    finally:
        q.close(timeout=10)
    torch.cuda.synchronize()
    assert stats["last_error"] is None and stats["dispatched"] == 16 * batch
    for owner, km in keyed_host._keyed.items():
        for name, value in km._get_states().items():
            assert torch.equal(getattr(keyed._keyed[owner], name).cpu(), value)
    assert col._jit_forward_fn.cache_info()["misses"] == 2
    for name, value in col_host.compute().items():
        assert torch.allclose(col.compute()[name].cpu().float(), value.float(), atol=1e-6, rtol=0), name


@pytest.mark.cuda
def test_a_capture_survives_the_cycle_collector_freeing_dead_graphs(cuda_device):
    """A compiled metric and its dispatches hold each other, so a dropped one
    is freed by the cycle collector; a collection that runs inside another
    capture destroys graphs there and invalidates it. The capture pauses the
    collector: with a collection forced at nearly every allocation, a
    capture next to dead captured metrics completes and replays right."""
    import gc

    x = torch.rand(64, device=cuda_device)
    for _ in range(3):
        dead = T.MeanSquaredError(device=cuda_device).jit_forward()
        dead.warmup(x, x)  # a captured graph, freed only by the collector
    del dead
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        live = T.MeanAbsoluteError(device=cuda_device).jit_forward()
        live.warmup(x, x)
    finally:
        gc.set_threshold(*thresholds)
    y = torch.rand(64, device=cuda_device)
    got = live(x, y)
    assert torch.allclose(got.cpu(), (x - y).abs().mean().cpu(), atol=1e-6)


@pytest.mark.cuda
def test_the_compiled_keyed_update_and_capacity_mode_on_the_card_match_the_cpu(cuda_device):
    n = 50
    card = T.MultiTenantCollection(_members(device=cuda_device), n, validate_ids=False, device=cuda_device)
    host = T.MultiTenantCollection(_members(device="cpu"), n, validate_ids=False, device="cpu")
    cohorts = _keyed_cohorts(7, [256] * 6, n)
    ids, preds, target = (np.stack([c[j] for c in cohorts[:3]]) for j in range(3))
    card.warmup(*(_t(x[0]).to(cuda_device) for x in (ids, preds, target)))
    card.update_many(*(_t(x).to(cuda_device) for x in (ids, preds, target)))
    for c in cohorts[3:]:
        card.update(*(_t(x).to(cuda_device) for x in c))
    for c in cohorts:
        host.update(*(_t(x) for x in c))
    torch.cuda.synchronize()
    for owner, km in host._keyed.items():
        for name, value in km._get_states().items():
            assert torch.equal(getattr(card._keyed[owner], name).cpu(), value)
    assert card.tenant_report()["rows_routed"] == host.tenant_report()["rows_routed"]
    rng = np.random.RandomState(8)
    auroc = T.AUROC(capacity=5000, device=cuda_device).jit_forward()
    auroc_host = T.AUROC(capacity=5000, device="cpu")
    for _ in range(4):
        s = rng.rand(1000).astype(np.float32)
        l = (rng.rand(1000) < s).astype(np.int64)
        got = auroc(_t(s).to(cuda_device), _t(l).to(cuda_device))
        want = auroc_host(_t(s), _t(l))
        assert abs(float(got) - float(want)) <= 1e-6
    assert torch.equal(auroc.buf.cpu(), auroc_host.buf) and int(auroc.count) == 4000
    assert abs(float(auroc.compute()) - float(auroc_host.compute())) <= 1e-6


# -- the regression slice ---------------------------------------------------------


class _ThreeSums(T.Metric):
    """A float32, a float64 and an int64 ``"sum"`` leaf: the merge takes the first,
    the plain ``index_add_`` the other two, in their own dtypes."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("f32", torch.zeros((2,), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("f64", torch.zeros((), dtype=torch.float64), dist_reduce_fx="sum")
        self.add_state("i64", torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, x, k):
        self.f32 = self.f32 + torch.stack([x.sum(), (x * x).sum()]).to(torch.float32)
        self.f64 = self.f64 + (x / 1024).sum()
        self.i64 = self.i64 + k.sum()

    def compute(self):
        return self.f64 / self.i64


@pytest.mark.cuda
def test_keyed_float32_float64_and_int64_sum_leaves_on_the_card_match_the_cpu(cuda_device):
    """Integer-valued float32 rows (the merge adds them exactly in any order),
    float64 rows on a 1/1024 grid and int64 counts past 2^24: the card's
    stacked state equals the CPU's exactly; the merge launches once per
    update, the plain route twice (one scatter per dtype)."""
    rng = np.random.RandomState(21)
    n = 300
    card = T.KeyedMetric(_ThreeSums(device=cuda_device), n, validate_ids=False, device=cuda_device)
    host = T.KeyedMetric(_ThreeSums(device="cpu"), n, validate_ids=False, device="cpu")
    for _ in range(4):
        ids = rng.randint(-2, n + 3, 4096)
        x = rng.randint(-1000, 1000, 4096).astype(np.float64)  # integer-valued; the float64 leaf adds x / 1024
        k = rng.randint(0, 2**40, 4096).astype(np.int64)
        card.update(_t(ids).to(cuda_device), _t(x).to(cuda_device), _t(k).to(cuda_device))
        host.update(_t(ids), _t(x), _t(k))
    torch.cuda.synchronize()
    for name in ("f32", "f64", "i64"):
        got = getattr(card, name)
        assert got.dtype == getattr(host, name).dtype and torch.equal(got.cpu(), getattr(host, name)), name
    assert _common.launch_count("segment_merge") == 4 and _common.launch_count("segment_scatter_add") == 0
    assert _common.dispatch_count("segment_scatter_add", "plain") == 4 * 2 * 2  # card and host

    members = lambda d: [T.MeanSquaredError(device=d), T.MeanAbsoluteError(device=d),  # noqa: E731
                         T.PearsonCorrcoef(streaming=True, device=d)]
    card = T.MultiTenantCollection(members(cuda_device), n, validate_ids=False, device=cuda_device)
    host = T.MultiTenantCollection(members("cpu"), n, validate_ids=False, device="cpu")
    _common.reset_dispatch_counters()
    for _ in range(3):
        ids = rng.randint(-1, n, 2048)
        p, t = rng.rand(2048).astype(np.float32), rng.rand(2048).astype(np.float32)
        card.update(_t(ids).to(cuda_device), _t(p).to(cuda_device), _t(t).to(cuda_device))
        host.update(_t(ids), _t(p), _t(t))
    assert _common.launch_count("segment_merge") == 3  # one per update, over the three bundles
    assert _common.launch_count("segment_scatter_add") == 0
    for owner, km in host._keyed.items():
        for name, value in km._get_states().items():
            got = getattr(card._keyed[owner], name).cpu()
            assert got.dtype == value.dtype, name
            if value.is_floating_point():
                torch.testing.assert_close(got, value, rtol=1e-5, atol=1e-9)
            else:
                assert torch.equal(got, value), name


@pytest.mark.cuda
def test_joint_grid_and_capacity_spearman_captured_in_a_graph_equal_their_eager_run(cuda_device):
    from metrics_tpu_torch.kernels.sketches import joint_grid_update

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(22)
    x = torch.rand(10_000, generator=gen, device=cuda_device)
    y = x + 0.1 * torch.randn(10_000, generator=gen, device=cuda_device)
    grid = torch.zeros((512, 512), device=cuda_device)
    eager, _ = joint_grid_update(grid, x, y, (0.0, 1.0), (-0.5, 1.5))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        joint_grid_update(grid, x, y, (0.0, 1.0), (-0.5, 1.5))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out, clipped = joint_grid_update(grid, x, y, (0.0, 1.0), (-0.5, 1.5))
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(out, eager) and float(out.sum()) == 10_000

    m = T.SpearmanCorrcoef(capacity=50_000, compute_on_step=False, device=cuda_device).jit_forward()
    host = T.SpearmanCorrcoef(capacity=50_000, compute_on_step=False, device="cpu")
    m.warmup(x, y)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            m(x, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for _ in range(4):
        host(x.cpu(), y.cpu())
    assert torch.equal(m.buf.cpu(), host.buf) and int(m.count) == 40_000
    assert abs(float(m.compute()) - float(host.compute())) <= 1e-6


# -- the retrieval slice ------------------------------------------------------------


_RETRIEVAL = ("RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut",
              "RetrievalNormalizedDCG")


def _retrieval_stream(seed, n=20_000, queries=700):
    """Query-major rows with bfloat16-rounded scores (exact ties), a few NaN."""
    rng = np.random.RandomState(seed)
    idx = np.sort(rng.randint(0, queries, n))
    preds = torch.from_numpy(rng.randn(n).astype(np.float32)).to(torch.bfloat16).float().numpy()
    preds[rng.rand(n) < 0.01] = np.nan
    return idx, preds, (rng.rand(n) < 0.05).astype(np.int64)


def _retrieval_members(device, **kw):
    return {name: getattr(T, name)(**({"k": 10} if name not in ("RetrievalMAP", "RetrievalMRR") else {}), **kw,
                                   device=device) for name in _RETRIEVAL}


@pytest.mark.cuda
def test_flat_retrieval_on_the_card_matches_the_cpu(cuda_device):
    from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric

    idx, preds, target = _retrieval_stream(30)
    card = T.MetricCollection(_retrieval_members(cuda_device, compute_on_step=False))
    host = T.MetricCollection(_retrieval_members("cpu", compute_on_step=False))
    for chunk in np.array_split(np.arange(idx.size), 7):
        card(_t(preds[chunk]).to(cuda_device), _t(target[chunk]).to(cuda_device), indexes=_t(idx[chunk]).to(cuda_device))
        host(_t(preds[chunk]), _t(target[chunk]), indexes=_t(idx[chunk]))
    got, want = card.compute(), host.compute()
    for name in want:
        assert got[name].device.type == cuda_device.type
        assert abs(float(got[name]) - float(want[name])) <= 1e-6, name
    marks = np.arange(idx.size)
    rows, lengths = RetrievalMetric._group_arrays_into_rows(
        _t(idx).to(cuda_device), _t(preds).to(cuda_device), _t(marks).to(cuda_device))
    host_rows, host_lengths = RetrievalMetric._group_arrays_into_rows(_t(idx), _t(preds), _t(marks))
    assert torch.equal(rows.cpu(), host_rows) and torch.equal(lengths.cpu(), host_lengths)


@pytest.mark.cuda
def test_padded_retrieval_on_the_card_matches_the_cpu_and_replays_compiled(cuda_device):
    rng = np.random.RandomState(31)
    batches = []
    for _ in range(6):
        preds = torch.from_numpy(rng.randn(64, 100).astype(np.float32)).to(torch.bfloat16).float().numpy()
        mask = np.arange(100)[None, :] < rng.randint(0, 101, 64)[:, None]
        batches.append((preds, (rng.rand(64, 100) < 0.05).astype(np.int64), mask))
    eager = T.MetricCollection(_retrieval_members(cuda_device, padded=True))
    compiled = T.MetricCollection(_retrieval_members(cuda_device, padded=True)).jit_forward()
    host = T.MetricCollection(_retrieval_members("cpu", padded=True))
    on_card = [tuple(_t(x).to(cuda_device) for x in b) for b in batches]
    compiled.warmup(on_card[0][0], on_card[0][1], mask=on_card[0][2])
    torch.cuda.synchronize()
    for (p, t, m), (cp, ct, cm) in zip(batches, on_card):
        want = host(_t(p), _t(t), mask=_t(m))
        got = eager(cp, ct, mask=cm)
        torch.cuda.set_sync_debug_mode("error")
        try:
            replayed = compiled(cp, ct, mask=cm)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for name in want:
            assert abs(float(got[name]) - float(want[name])) <= 1e-6, name
            assert float(replayed[name]) == float(got[name]), name
    for name, m in host.items(keep_base=True):
        assert int(eager[name].query_total) == int(compiled[name].query_total) == int(m.query_total)
        assert abs(float(compiled[name].compute()) - float(m.compute())) <= 1e-6


@pytest.mark.cuda
def test_the_reservoir_on_the_card_is_bit_exact_and_replays(cuda_device):
    from metrics_tpu_torch.kernels.sketches import uniform_hash

    rng = np.random.RandomState(32)
    ids = rng.randint(-2**62, 2**62, 1_000_000)
    assert torch.equal(uniform_hash(_t(ids).to(cuda_device)).cpu(), uniform_hash(_t(ids)))
    idx, preds, target = _retrieval_stream(33, n=60_000, queries=3000)
    card = T.RetrievalMAP(sketched=True, sketch_capacity=8192, compute_on_step=False, device=cuda_device).jit_forward()
    host = T.RetrievalMAP(sketched=True, sketch_capacity=8192, device="cpu")
    chunks = np.array_split(np.arange(idx.size), 6)
    on_card = [tuple(_t(x[chunk]).to(cuda_device) for x in (preds, target, idx)) for chunk in chunks]
    card.warmup(on_card[0][0], on_card[0][1], indexes=on_card[0][2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for p, t, i in on_card:
            card(p, t, indexes=i)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for chunk in chunks:
        host.update(_t(preds[chunk]), _t(target[chunk]), indexes=_t(idx[chunk]))
    for name in ("res_key", "res_qid", "res_pred", "res_target", "res_seen", "res_overflow"):
        got, want = getattr(card, name).cpu(), getattr(host, name)
        if got.is_floating_point():  # bit for bit, the NaN scores too
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want), name
    with pytest.warns(UserWarning, match="sampled"):
        got = card.compute()
    with pytest.warns(UserWarning, match="sampled"):
        assert abs(float(got) - float(host.compute())) <= 1e-6


@pytest.mark.cuda
def test_the_keyed_padded_update_launches_b3_once_per_bundle(cuda_device):
    def members(device):
        return [T.RetrievalMAP(padded=True, device=device), T.RetrievalMRR(padded=True, device=device),
                T.RetrievalNormalizedDCG(padded=True, k=10, device=device)]

    n = 500
    card = T.MultiTenantCollection(members(cuda_device), n, validate_ids=False, device=cuda_device)
    host = T.MultiTenantCollection(members("cpu"), n, validate_ids=False, device="cpu")
    rng = np.random.RandomState(34)
    for _ in range(4):
        ids = rng.randint(-1, n, 1024)
        preds = rng.randn(1024, 100).astype(np.float32)
        target = (rng.rand(1024, 100) < 0.05).astype(np.int64)
        card.update(*(_t(x).to(cuda_device) for x in (ids, preds, target)))
        host.update(*(_t(x) for x in (ids, preds, target)))
    torch.cuda.synchronize()
    assert _common.launch_count("segment_merge") == 4  # one per update, over the three bundles
    for op in ("stat_scores_counts", "confmat_counts", "segment_scatter_add", "segment_scatter_max",
               "segment_scatter_min", "label_score_histograms"):
        assert _common.launch_count(op) == 0, op
    for owner, km in host._keyed.items():
        assert torch.equal(card._keyed[owner].query_total.cpu(), km.query_total)
        torch.testing.assert_close(card._keyed[owner].value_sum.cpu(), km.value_sum, rtol=1e-5, atol=1e-5)
    got, want = card.compute(), host.compute()
    for name in want:
        torch.testing.assert_close(got[name].cpu(), want[name], rtol=1e-5, atol=1e-5, equal_nan=True)


# -- the rest of the metric inventory ---------------------------------------------------------


@pytest.mark.cuda
def test_the_inception_extractor_taps_on_the_card_match_the_cpu(cuda_device):
    """Every tap of the seeded net on the card equals the CPU's within 1e-4
    relative to the tap's largest magnitude (full float32: no TF32), from
    an upsampled and a downsampled input."""
    from metrics_tpu_torch.image.inception_net import InceptionFeatureExtractor, seeded_inception

    net_cpu, net_gpu = seeded_inception(1), seeded_inception(1)
    gen = torch.Generator().manual_seed(3)
    for side in (32, 320):
        imgs = torch.randint(0, 256, (4, 3, side, side), generator=gen, dtype=torch.uint8)
        for tap in (64, 192, 768, 2048, "logits_unbiased"):
            want = InceptionFeatureExtractor(tap, net=net_cpu, device="cpu")(imgs)
            got = InceptionFeatureExtractor(tap, net=net_gpu, device=cuda_device)(imgs.to(cuda_device)).cpu()
            scale = float(want.abs().max())
            torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_tf32_stays_off_in_the_extractor_and_embedding_similarity(cuda_device):
    """With TF32 switched on for the whole process, the extractor and
    ``embedding_similarity`` still compute in full float32: identical rows
    read 1.0 within 1e-6, and the process's flags are restored after."""
    from metrics_tpu_torch.functional import embedding_similarity
    from metrics_tpu_torch.image.inception_net import InceptionFeatureExtractor, seeded_inception

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        gen = torch.Generator().manual_seed(4)
        row = torch.randn(1, 128, generator=gen)
        sim = embedding_similarity(row.repeat(64, 1).to(cuda_device), zero_diagonal=False)
        torch.testing.assert_close(sim.cpu(), torch.ones(64, 64), rtol=0, atol=1e-6)
        x = torch.randn(256, 128, generator=gen)
        torch.testing.assert_close(embedding_similarity(x.to(cuda_device)).cpu(), embedding_similarity(x),
                                   rtol=1e-5, atol=1e-6)
        net = seeded_inception(2)
        imgs = torch.randint(0, 256, (2, 3, 64, 64), generator=gen, dtype=torch.uint8)
        want = InceptionFeatureExtractor(2048, net=net, device="cpu")(imgs)
        got = InceptionFeatureExtractor(2048, net=net, device=cuda_device)(imgs.to(cuda_device)).cpu()
        torch.testing.assert_close(got / want.abs().max(), want / want.abs().max(), rtol=0, atol=1e-4)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
def test_fixed_length_poisson_sampler_on_the_card_matches_the_cpu_contract(cuda_device):
    """The card's fixed-length resample from a seeded generator equals the
    CPU's contract applied to the same Poisson counts and visit orders."""
    from metrics_tpu_torch.wrappers.bootstrapping import _bootstrap_indices, _fixed_length_repeat

    for seed, num, size in ((0, 1, 1), (1, 3, 7), (2, 20, 4096)):
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        got = _bootstrap_indices(num, size, gen, "poisson")
        replay = torch.Generator(device=cuda_device).manual_seed(seed)
        counts = torch.poisson(torch.ones(num, size, device=cuda_device), generator=replay).long().cpu()
        order = torch.argsort(torch.rand(num, size, generator=replay, device=cuda_device), dim=1).cpu()
        assert got.device.type == "cuda" and got.shape == (num, size)
        assert torch.equal(got.cpu(), _fixed_length_repeat(order, torch.gather(counts, 1, order), size))


@pytest.mark.cuda
def test_the_pure_bootstrap_path_makes_no_synchronizing_call(cuda_device):
    import warnings

    b = T.BootStrapper(T.Accuracy(device=cuda_device), num_bootstraps=20, sampling_strategy="poisson")
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    preds = torch.rand(1024, 10, generator=gen, device=cuda_device).softmax(-1)
    target = torch.randint(0, 10, (1024,), generator=gen, device=cuda_device)
    state = b.apply_update(b.init_state(), preds, target)  # first call: allocator and library warm-up
    _common.reset_dispatch_counters()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(3):
                state = b.apply_update(state, preds, target)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in seen if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
    assert syncs == []
    assert _common.launch_count("stat_scores_counts") == 0
    out = b.apply_compute(state, process_group=None)
    assert out["mean"].device.type == "cuda" and 0.0 <= float(out["mean"]) <= 1.0


@pytest.mark.cuda
def test_the_pure_bootstrap_path_counts_its_macro_children_in_one_b1_launch_an_update(cuda_device, monkeypatch):
    """A macro child's counts go through B1's batched form, one launch an
    update for all 20 children, with no synchronizing call; the statistics
    equal the CPU's pure path fed the card's index matrices."""
    import warnings

    import metrics_tpu_torch.wrappers.bootstrapping as boot

    def build(device):
        return T.BootStrapper(T.Accuracy(average="macro", num_classes=10, device=device), num_bootstraps=20,
                              raw=True, seed=4)

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    batches = [(torch.rand(1024, 10, generator=gen, device=cuda_device).softmax(-1),
                torch.randint(0, 10, (1024,), generator=gen, device=cuda_device)) for _ in range(3)]
    real, recorded = boot._bootstrap_indices, []
    monkeypatch.setattr(boot, "_bootstrap_indices", lambda *a, **k: recorded.append(real(*a, **k)) or recorded[-1])
    b = build(cuda_device)
    b.apply_update(b.init_state(), *batches[0])  # first call: allocator and library warm-up
    recorded.clear()
    state = b.init_state()
    _common.reset_dispatch_counters()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for preds, target in batches:
                state = b.apply_update(state, preds, target)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in seen if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
    assert syncs == []
    assert _common.launch_count("stat_scores_counts") == len(batches)
    got = b.apply_compute(state, process_group=None)
    replay = iter(recorded)
    monkeypatch.setattr(boot, "_bootstrap_indices", lambda *a, **k: next(replay).cpu())
    cpu = build("cpu")
    cpu_state = cpu.init_state()
    for preds, target in batches:
        cpu_state = cpu.apply_update(cpu_state, preds.cpu(), target.cpu())
    want = cpu.apply_compute(cpu_state, process_group=None)
    for key in want:
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0, atol=1e-6)


# -- observability on the card ----------------------------------------------------


def _count_syncs(fn):
    """``fn()``'s synchronizing calls, as ``torch.cuda.set_sync_debug_mode``
    warns them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in seen if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]


@pytest.mark.cuda
def test_the_compiled_health_guard_makes_no_synchronizing_call(cuda_device):
    """Policy ``"record"``: the compiled collection's replays make no
    synchronizing call, the flags of a NaN poisoned into a state are noted
    once their copy completes (at most one dispatch late), and policy
    ``"off"`` replays the graph captured without the guard."""
    from metrics_tpu_torch import observability

    observability.reset()
    observability.set_health_policy("record")
    try:
        card = T.MetricCollection([T.MeanSquaredError(device=cuda_device), T.MeanAbsoluteError(device=cuda_device)])
        card.jit_forward()
        x = torch.rand(64, device=cuda_device)
        card.warmup(x, x)
        assert _count_syncs(lambda: [card(x, x) for _ in range(5)]) == []
        card["MeanSquaredError"].sum_squared_error.fill_(float("nan"))
        assert _count_syncs(lambda: card(x, x)) == []
        torch.cuda.synchronize()
        observability.HEALTH.drain()
        key = card["MeanSquaredError"].telemetry_key
        record = observability.HEALTH.summary()["metrics"][key]
        assert record["nan"] >= 1 and record["checks"] >= 6
        assert observability.HEALTH.in_flight() == 0
    finally:
        observability.set_health_policy("off")
        observability.reset()


@pytest.mark.cuda
def test_a_sampled_dispatch_splits_by_cuda_events(cuda_device):
    from metrics_tpu_torch import observability
    from metrics_tpu_torch.observability.profiling import split_series_keys

    observability.reset()
    observability.set_profiling(1)
    try:
        card = T.MetricCollection(_compiled_members(cuda_device)).jit_forward()
        probs, target = _softmax_batches(1, 1)[0]
        p, t = _t(probs).to(cuda_device), _t(target).to(cuda_device)
        card.warmup(p, t)
        for _ in range(3):
            card(p, t)
        hists = observability.snapshot()["histograms"]
        host, device = (hists[k] for k in split_series_keys("compiled"))
        assert host["count"] == device["count"] == 3
        assert device["sum"] > 0.0
        assert observability.snapshot()["profiling"]["samples"] == {"compiled": 3}
    finally:
        observability.set_profiling(0)
        observability.reset()


@pytest.mark.cuda
def test_the_ledger_bytes_match_the_allocator_within_a_block_per_tensor(cuda_device):
    """The ledger's logical bytes against the caching allocator's block under
    each state tensor (``torch.cuda.memory_snapshot()``): within 512 bytes a
    tensor, the allocator's rounding."""
    from metrics_tpu_torch import observability

    mtc = T.MultiTenantCollection([T.MeanSquaredError(device=cuda_device), T.MeanAbsoluteError(device=cuda_device),
                                   T.PearsonCorrcoef(streaming=True, device=cuda_device)], 10_000, device=cuda_device)
    mtc.build()
    tensors = [v for km in mtc._keyed.values() for v in km._get_states().values()]
    ptrs = {t.data_ptr() for t in tensors}
    blocks = {}
    for segment in torch.cuda.memory_snapshot():
        address = segment["address"]
        for block in segment["blocks"]:
            if address in ptrs:
                blocks[address] = block["size"]
            address += block["size"]
    assert set(blocks) == ptrs
    observability.LEDGER.track(mtc)
    try:
        ledger = observability.LEDGER.owner_bytes(mtc)
        assert ledger == sum(v.numel() * v.element_size() for v in tensors) == 680_000
        for t in tensors:
            assert 0 <= blocks[t.data_ptr()] - t.numel() * t.element_size() < 512
    finally:
        observability.LEDGER.untrack(mtc)


@pytest.mark.cuda
def test_a_torch_profiler_trace_names_each_member_of_a_collection_forward(cuda_device):
    members = _compiled_members(cuda_device)
    card = T.MetricCollection(members)
    probs, target = _softmax_batches(1, 1)[0]
    p, t = _t(probs).to(cuda_device), _t(target).to(cuda_device)
    card(p, t)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        card(p, t)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.key.startswith("metrics/")}
    assert {f"metrics/{type(m).__name__}.forward" for m in card.values()} <= names


# -- the durability slice -----------------------------------------------------------


def _durable_acc(device, n=64):
    return T.KeyedMetric(T.Accuracy(device=device), n, validate_ids=False, device=device)


def _acc_batch(rng, n, rows):
    return _t(rng.randint(0, n, rows)), _t(rng.rand(rows).astype(np.float32)), _t(rng.randint(0, 2, rows))


@pytest.mark.cuda
def test_a_checkpoint_restores_across_devices(cuda_device, tmp_path):
    from metrics_tpu_torch.durability import CheckpointManager

    rng = np.random.RandomState(0)
    card, host = _durable_acc(cuda_device), _durable_acc("cpu")
    for _ in range(3):
        batch = _acc_batch(rng, 64, 200)
        card.update(*(x.to(cuda_device) for x in batch))
        host.update(*batch)
    CheckpointManager(str(tmp_path / "card"), card).save()
    CheckpointManager(str(tmp_path / "host"), host).save()
    on_cpu, on_card = _durable_acc("cpu"), _durable_acc(cuda_device)
    CheckpointManager(str(tmp_path / "card"), on_cpu).restore(on_cpu)
    CheckpointManager(str(tmp_path / "host"), on_card).restore(on_card)
    for name, value in host._get_states().items():
        assert torch.equal(getattr(on_cpu, name), value) and torch.equal(getattr(on_card, name).cpu(), value)
        assert getattr(on_card, name).is_cuda
    assert torch.equal(on_card.compute().cpu().isnan(), host.compute().isnan())


@pytest.mark.cuda
def test_the_compiled_keyed_update_after_grow_and_compact_equals_eager(cuda_device):
    rng = np.random.RandomState(1)
    batches = [_acc_batch(rng, 10, 128) for _ in range(4)]
    compiled, eager = _durable_acc(cuda_device, 10), _durable_acc(cuda_device, 10)
    compiled.warmup(*(x.to(cuda_device) for x in batches[0]))
    for obj in (compiled, eager):
        for step, batch in zip(("grow", "compact", "grow", None), batches):
            obj.update(*(x.to(cuda_device) for x in batch))
            if step == "grow":
                obj.grow(40)
            elif step == "compact":
                obj.compact(10)
    for name, value in eager._get_states().items():
        assert torch.equal(getattr(compiled, name), value), name
    fn = compiled.__dict__["_keyed_update_fn"] or compiled.__dict__["_keyed_update_copy_fn"]
    assert fn._cache_size() == 3  # capacities 10, 64 and 16, the second grow replays
    # four updates of each owner, and the warm-up run of each of the three captures
    assert _common.launch_count("segment_merge") == 2 * 4 + 3
    assert _common.launch_count("segment_scatter_add") == 0 and _common.launch_count("segment_scatter_max") == 0


@pytest.mark.cuda
def test_a_spill_round_trip_under_a_held_compiled_graph(cuda_device):
    from metrics_tpu_torch.durability import TenantSpiller

    rng = np.random.RandomState(2)
    batches = [_acc_batch(rng, 64, 256) for _ in range(6)]
    compiled, control = _durable_acc(cuda_device), _durable_acc(cuda_device)
    compiled.warmup(*(x.to(cuda_device) for x in batches[0]))
    spiller = TenantSpiller(compiled, resident_cap=8, auto=True)
    held = compiled.tp.data_ptr()
    for batch in batches:
        for obj in (compiled, control):
            obj.update(*(x.to(cuda_device) for x in batch))
    assert compiled.tp.data_ptr() == held  # evictions and fault-backs wrote the graph's own tensors
    report = spiller.report()
    assert report["conservation_ok"] and report["resident_under_cap"] and report["spilled"] > 0
    got, want = compiled.compute(), control.compute()
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got[~want.isnan()], want[~want.isnan()])
    for name, value in control._get_states().items():
        assert torch.equal(getattr(compiled, name), value), name


@pytest.mark.cuda
def test_an_async_save_adds_no_synchronizing_call_to_the_updates_in_flight(cuda_device, tmp_path):
    import warnings

    from metrics_tpu_torch.durability import CheckpointManager

    rng = np.random.RandomState(3)
    m = T.KeyedMetric(T.ConfusionMatrix(num_classes=16, device=cuda_device), 4096, validate_ids=False,
                      device=cuda_device)
    pool = []
    for _ in range(8):
        logits = rng.rand(256, 16).astype(np.float32)
        pool.append(tuple(_t(a).to(cuda_device) for a in (rng.randint(0, 4096, 256), logits / logits.sum(1, keepdims=True),
                                                           rng.randint(0, 16, 256))))
    m.update(*pool[0])
    mgr = CheckpointManager(str(tmp_path), m)
    mgr.save()
    m.update(*pool[1])
    torch.cuda.synchronize()

    def syncs(fn):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return [w for w in seen if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]

    base = syncs(lambda: [m.update(*b) for b in pool])
    steps = [0]

    def fly():
        future = mgr.save_async()
        while not future.done() or steps[0] < 4:
            m.update(*pool[steps[0] % len(pool)])
            steps[0] += 1
        assert future.result(timeout=60)["kind"] == "delta"

    during = syncs(fly)
    assert len([w for w in during if "durability" not in w.filename]) == len(base) / len(pool) * steps[0]
    assert [w for w in during if "durability" in w.filename] == []


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,c,b", [(4096, 1, 1, 2048), (4096, 1, 10, 2048), (20, 1024, 1000, 2048),
                                     (300, 5, 7, 2048), (65_536, 1, 1, 2048), (5, 0, 7, 2048), (3, 64, 1001, 2048),
                                     (4, 300, 1000, 2048), (3, 16, 4, 65536), (5, 7, 3, 40_000)])
@pytest.mark.parametrize("form", ["dense", "ids32", "ids64"])
def test_histogram_batched_kernel_matches_plain(cuda_device, r, n, c, b, form):
    """B5's batched entry at the paths' stacks (the keyed binary and
    10-class rows, a bootstrap's resamples), C = 7, a last z group of one
    slice (65,536), slices of no row, ragged tiles, 16-byte loads and the
    global mode (B past one tile), one launch for the stack: == the plain
    batched version on the card and on the CPU. Ids in [-1, C]; the outputs
    come from a pool of -1s, so a cell left unwritten shows."""
    gen = torch.Generator(device=cuda_device).manual_seed(r + c + b)
    scores = torch.rand((r, n, c), generator=gen, device=cuda_device)
    if form == "dense":
        labels = torch.randint(0, 2, (r, n, c), generator=gen, device=cuda_device, dtype=torch.int32)
    else:
        labels = torch.randint(-1, c + 1, (r, n), generator=gen, device=cuda_device)
        labels = labels.to(torch.int32 if form == "ids32" else torch.int64)
    _dirty_pool(cuda_device, 8 * r * c * b)
    got = bc.label_score_histograms_batched_cuda(scores, labels, b)
    torch.cuda.synchronize()
    assert _common.launch_count(_HIST) == 1
    assert got[0].shape == got[1].shape == (r, c, b) and got[2].shape == (r,)
    for g, w, h in zip(got, bc.label_score_histograms_batched_torch(scores, labels, b),
                       bc.label_score_histograms_batched_torch(scores.cpu(), labels.cpu(), b)):
        assert g.dtype == torch.float32 and torch.equal(g, w) and torch.equal(g.cpu(), h)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lo,hi", [(2048, 0.0, 1.0), (1000, 0.0, 1.0), (4096, 0.1, 0.7)])
def test_histogram_batched_kernel_at_every_bin_edge(cuda_device, b, lo, hi):
    """Every bin edge with its float32 neighbours, NaN, +-inf, signed zeros,
    subnormals and scores outside [lo, hi]: one score a slice with dense
    labels, and all in one slice with class ids, == the plain version on the
    card and on the CPU."""
    edges = (lo + (hi - lo) * torch.arange(b + 1, dtype=torch.float64) / b).float()
    special = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1e-45, -1e-45, -1e-39, lo - 1.0,
                            hi + 1.0])
    x = torch.cat([edges, torch.nextafter(edges, torch.tensor(2.0)), torch.nextafter(edges, torch.tensor(-1.0)),
                   special]).to(cuda_device)
    alternate = (torch.arange(x.shape[0], device=cuda_device) % 2).int()
    for scores, labels in ((x.reshape(-1, 1, 1), alternate.reshape(-1, 1, 1)),
                           (x.reshape(1, -1, 1).expand(1, -1, 3).contiguous(), alternate.reshape(1, -1).long())):
        got = bc.label_score_histograms_batched_cuda(scores, labels, b, lo, hi)
        torch.cuda.synchronize()
        for g, w, h in zip(got, bc.label_score_histograms_batched_torch(scores, labels, b, lo, hi),
                           bc.label_score_histograms_batched_torch(scores.cpu(), labels.cpu(), b, lo, hi)):
            assert torch.equal(g, w) and torch.equal(g.cpu(), h)
    assert _common.launch_count(_HIST) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("r,c,b,form", [(131_200, 8, 2048, "dense"), (66_000, 1, 32_768, "ids64")])
def test_histogram_batched_kernel_past_2_31_cells(cuda_device, r, c, b, form):
    """Each output past 2^31 cells, in the store mode and in the global mode
    (which also takes more than 65,535 slices on its grid's y axis): one
    launch at int64 offsets, == the plain version on the card."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    scores = torch.rand((r, 1, c), generator=gen, device=cuda_device)
    labels = (torch.randint(0, 2, (r, 1, c), generator=gen, device=cuda_device, dtype=torch.int32) if form == "dense"
              else torch.randint(-1, c + 1, (r, 1), generator=gen, device=cuda_device))
    got = bc.label_score_histograms_batched_cuda(scores, labels, b)
    torch.cuda.synchronize()
    assert r * c * b > 2**31 and _common.launch_count(_HIST) == 1
    want = bc.label_score_histograms_batched_torch(scores, labels, b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert float(got[0].sum(dtype=torch.float64) + got[1].sum(dtype=torch.float64)) == r * c


@pytest.mark.cuda
def test_the_batched_histogram_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    scores = torch.rand(4, 3, 2, device=cuda_device)
    with pytest.raises(ValueError, match="one shape"):
        bc.label_score_histograms_batched_cuda(scores, torch.zeros(4, 3, 1, dtype=torch.int32, device=cuda_device), 8)
    with pytest.raises(ValueError, match="class ids of shape"):
        bc.label_score_histograms_batched_cuda(scores, torch.zeros(4, 2, dtype=torch.int64, device=cuda_device), 8)
    with pytest.raises(ValueError, match="num_bins"):
        bc.label_score_histograms_batched_cuda(scores, torch.zeros(4, 3, dtype=torch.int64, device=cuda_device), 0)
    assert _common.launch_count(_HIST) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("num_classes", [None, 10])
def test_a_keyed_sketched_auroc_on_the_card_matches_the_cpu(cuda_device, num_classes):
    """The keyed rows of a sketched curve inside the vmap go to B5's batched
    entry: one launch for the update's 512 rows (binary, and 10-class one
    against the rest with class ids), then the merge routes their histograms; no
    plain B5 dispatch on the card; states == the CPU's exactly."""
    rng = np.random.RandomState(6)
    if num_classes is None:
        scores = rng.rand(512).astype(np.float32)
        batch = (_t(rng.randint(-1, 64, 512)), _t(scores), _t((rng.rand(512) < scores).astype(np.int64)))
    else:
        logits = rng.rand(512, num_classes).astype(np.float32)
        batch = (_t(rng.randint(-1, 64, 512)), _t(logits / logits.sum(1, keepdims=True)),
                 _t(rng.randint(0, num_classes, 512)))
    kw = dict(sketched=True, num_classes=num_classes)
    card = T.KeyedMetric(T.AUROC(**kw, device=cuda_device), 64, validate_ids=False, device=cuda_device)
    host = T.KeyedMetric(T.AUROC(**kw, device="cpu"), 64, validate_ids=False, device="cpu")
    card.update(*(x.to(cuda_device) for x in batch))
    assert _common.launch_count(_HIST) == 1 and _common.launch_count("segment_merge") == 1
    assert _common.dispatch_count(_HIST, "torch") == 0
    host.update(*batch)
    for name in ("pos_hist", "neg_hist", "sketch_clipped"):
        assert torch.equal(getattr(card, name).cpu(), getattr(host, name)), name
    got, want = card.compute().cpu(), host.compute()
    assert torch.equal(got.isnan(), want.isnan()) and float(torch.nan_to_num(got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_the_histogram_vmap_rule_launches_once_for_nested_vmaps_and_unbatched_labels(cuda_device):
    """Nested vmaps flatten into one stack; an unbatched label tensor is
    broadcast along the stack: one launch each, == the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    scores = torch.rand((6, 5, 1, 4), generator=gen, device=cuda_device)
    ids = torch.randint(0, 4, (6, 5, 1), generator=gen, device=cuda_device)
    got = torch.func.vmap(torch.func.vmap(lambda s, i: bc._label_score_histograms_onevsrest(s, i, 64)))(scores, ids)
    want = bc.label_score_histograms_batched_torch(scores.reshape(30, 1, 4), ids.reshape(30, 1), 64)
    assert all(torch.equal(g.reshape(w.shape), w) for g, w in zip(got, want))
    assert _common.launch_count(_HIST) == 1
    labels = torch.randint(0, 2, (1, 4), generator=gen, device=cuda_device, dtype=torch.int32)
    got = torch.func.vmap(lambda s: bc.label_score_histograms(s, labels, 64))(scores[0])
    want = bc.label_score_histograms_batched_torch(scores[0], labels.expand(5, 1, 4).contiguous(), 64)
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and _common.launch_count(_HIST) == 2


@pytest.mark.cuda
def test_a_keyed_confusion_matrix_on_the_card_matches_the_cpu(cuda_device):
    # its rows inside the vmap go to B2's batched form: one launch for the
    # update's 512 rows, then the merge routes their counts
    rng = np.random.RandomState(4)
    logits = rng.rand(512, 16).astype(np.float32)
    batch = (_t(rng.randint(0, 64, 512)), _t(logits / logits.sum(1, keepdims=True)), _t(rng.randint(0, 16, 512)))
    card = T.KeyedMetric(T.ConfusionMatrix(num_classes=16, device=cuda_device), 64, validate_ids=False,
                         device=cuda_device)
    host = T.KeyedMetric(T.ConfusionMatrix(num_classes=16, device="cpu"), 64, validate_ids=False, device="cpu")
    card.update(*(x.to(cuda_device) for x in batch))
    host.update(*batch)
    assert torch.equal(card.confmat.cpu(), host.confmat) and int(host.confmat.sum()) == 512
    assert _common.launch_count("confmat_counts") == 1 and _common.launch_count("segment_merge") == 1
