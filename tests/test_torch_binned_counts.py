"""The port's label/score histograms (B5) and sketch curve functions against the JAX package's.

The plain PyTorch version (``label_score_histograms_torch``) is held
bit-identical to the JAX package's ``label_score_histograms_xla`` and to its
Pallas kernel in interpret mode, on the same numpy inputs, over the case
matrix of ``TestSketchHistogramKernel`` in
``tests/kernels/test_pallas_kernels.py``, plus the NaN/+-inf/+-0/subnormal
case and every bin edge with its float32 neighbours. Counts of ones are
exact in float32, so no tolerance applies. The ``hist_*`` curve functions
are held within 1e-6 of the JAX ones on the same histograms, and
``binned_tp_fp_fn`` exactly. The wrapper runs the plain version for a CPU
tensor and launches nothing; the cases that launch kernel B5 live in
``tests/test_torch_card.py``. The kernel's plan (``histogram_plan``: tile
width, row chunks, mode, shared memory) and load width are pure functions
held here; the CUDA path's plumbing (one C call, no fill, no device context)
is held against a fake library; and the class-id label form is held exact
against the JAX package's functions on the one-hot of the ids. The batched
form (``label_score_histograms_batched_torch``) is held exact against
``jax.vmap`` of the Pallas kernel in interpret mode and of ``_xla``, slice
by slice, with both label forms; its vmap rule dispatches once a stack
(nested vmaps, unbatched labels), and its plan and CUDA plumbing are held
as the single form's are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.kernels import sketches as jax_sketches
from metrics_tpu.kernels.binned_counts import (
    binned_tp_fp_fn as jax_binned_tp_fp_fn,
    label_score_histograms_pallas,
    label_score_histograms_xla,
)
from metrics_tpu.utilities.data import to_onehot as jax_to_onehot
from metrics_tpu_torch.kernels import _common, sketches
from metrics_tpu_torch.kernels import binned_counts as bc
from metrics_tpu_torch.kernels.binned_counts import (
    ADD,
    GLOBAL,
    SHARED_BUDGET,
    STORE,
    _label_score_histograms_onevsrest,
    batched_histogram_plan,
    binned_tp_fp_fn,
    histogram_plan,
    label_score_histograms,
    label_score_histograms_batched_cuda,
    label_score_histograms_batched_torch,
    label_score_histograms_cuda,
    label_score_histograms_torch,
    load_width,
    tile_shared_bytes,
)

_OP = "label_score_histograms"


@pytest.fixture(autouse=True)
def _zero_counters():
    _common.reset_dispatch_counters()
    yield
    _common.reset_dispatch_counters()


def _plain(preds, target, b, lo=0.0, hi=1.0):
    pos, neg, clipped = label_score_histograms_torch(torch.from_numpy(preds), torch.from_numpy(target), b, lo, hi)
    c = preds.shape[1]
    assert pos.dtype == neg.dtype == clipped.dtype == torch.float32
    assert pos.shape == neg.shape == (c, b) and clipped.shape == ()
    return pos.numpy(), neg.numpy(), clipped.numpy()


def _assert_bit_identical(preds, target, b, lo=0.0, hi=1.0, pallas=True):
    got = _plain(preds, target, b, lo, hi)
    refs = [label_score_histograms_xla(jnp.asarray(preds), jnp.asarray(target), b, lo, hi)]
    if pallas:
        refs.append(label_score_histograms_pallas(jnp.asarray(preds), jnp.asarray(target), b, lo, hi,
                                                  interpret=True))
    for ref in refs:
        for g, w in zip(got, ref):
            assert np.asarray(w).dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))
    return got


def _bf16_to_f32(x):
    """float32 values that bfloat16 holds exactly (the rounding of both
    frameworks is then irrelevant)."""
    return (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


class TestLabelScoreHistograms:
    @pytest.mark.parametrize("n,c,b", [(64, 1, 16), (300, 4, 64), (1000, 3, 256), (7, 2, 2048)])
    def test_parity_bit_identical(self, n, c, b):
        rng = np.random.RandomState(n + c + b)
        _assert_bit_identical(rng.rand(n, c).astype(np.float32), rng.randint(0, 2, (n, c)), b)

    @pytest.mark.parametrize("seed", range(5))
    def test_out_of_range_clip_parity_fuzz(self, seed):
        rng = np.random.RandomState(seed)
        n, c, b = rng.randint(1, 300), rng.randint(1, 5), int(rng.choice([8, 64, 500]))
        preds = (rng.rand(n, c) * 2.0 - 0.5).astype(np.float32)  # spills [0, 1]
        _, _, clipped = _assert_bit_identical(preds, rng.randint(0, 2, (n, c)), b)
        assert float(clipped) > 0

    def test_custom_range(self):
        rng = np.random.RandomState(11)
        _assert_bit_identical((rng.randn(200, 2) * 3).astype(np.float32), rng.randint(0, 2, (200, 2)), 32, -2.0, 2.0)

    @pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("tdtype", [np.int32, np.float32])
    def test_dtypes(self, pdtype, tdtype):
        rng = np.random.RandomState(12)
        preds = _bf16_to_f32(rng.rand(64, 2).astype(np.float32))
        target = rng.randint(0, 2, (64, 2)).astype(tdtype)
        want = label_score_histograms_xla(jnp.asarray(preds).astype(pdtype), jnp.asarray(target), 16)
        want_p = label_score_histograms_pallas(jnp.asarray(preds).astype(pdtype), jnp.asarray(target), 16,
                                               interpret=True)
        t_preds = torch.from_numpy(preds).to(getattr(torch, pdtype))
        got = label_score_histograms_torch(t_preds, torch.from_numpy(target), 16)
        for g, w, wp in zip(got, want, want_p):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), np.asarray(wp))

    def test_empty_batch(self):
        pos, neg, clipped = _plain(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), 8)
        assert not pos.any() and not neg.any() and float(clipped) == 0.0
        want = label_score_histograms_pallas(jnp.zeros((0, 3), jnp.float32), jnp.zeros((0, 3), jnp.int32), 8,
                                             interpret=True)
        for g, w in zip((pos, neg, clipped), want):
            np.testing.assert_array_equal(g, np.asarray(w))

    def test_single_row_and_mass_conservation(self):
        pos, neg, clipped = _plain(np.asarray([[0.5]], np.float32), np.asarray([[1]]), 4)
        assert pos.sum() == 1.0 and neg.sum() == 0.0 and float(clipped) == 0.0

    def test_max_pallas_bins(self):
        rng = np.random.RandomState(13)
        _assert_bit_identical(rng.rand(16, 1).astype(np.float32), rng.randint(0, 2, (16, 1)), 4096)

    def test_nan_inf_signed_zero(self):
        """NaN lands in bin 0 unclipped (the naive cast of NaN would be
        -2**31); +-inf clip into the edge bins and are counted; a negative
        subnormal reads as zero, as XLA reads it, and is not clipped."""
        f32 = np.float32
        preds = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, np.nextafter(f32(1), f32(2)), -1e-8,
                          0.125, np.nextafter(f32(0.125), f32(0)), 0.999999], f32).reshape(-1, 1)
        pos, neg, clipped = _assert_bit_identical(preds, np.ones(preds.shape, np.int32), 8)
        np.testing.assert_array_equal(pos[0], [7, 1, 0, 0, 0, 0, 0, 4])
        assert not neg.any() and float(clipped) == 4.0
        tiny = np.array([[-1e-45], [1e-45], [-1e-39], [-1e-30]], f32)
        _, _, clipped = _assert_bit_identical(tiny, np.zeros(tiny.shape, np.int32), 8)
        assert float(clipped) == 1.0  # only -1e-30, a normal float32

    @pytest.mark.parametrize("b,lo,hi", [(2048, 0.0, 1.0), (1000, 0.0, 1.0), (4096, 0.0, 1.0), (32, -2.0, 2.0),
                                         (4096, 0.1, 0.7), (64, 0.1, 0.7)])
    def test_every_bin_edge_and_its_neighbours(self, b, lo, hi):
        """Bit-identical to the eager ``_xla`` (IEEE division by the span)
        at every edge. The compiled formulations (interpret ``_pallas``,
        ``jit(_xla)``) multiply by the span's reciprocal instead, which moves
        edge scores when the span is not a power of two (0.6 here), so they
        are held to the plain version only where it is."""
        edges = (lo + (hi - lo) * np.arange(b + 1, dtype=np.float64) / b).astype(np.float32)
        preds = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                                np.nextafter(edges, np.float32(-np.inf))]).reshape(-1, 1)
        target = (np.arange(preds.shape[0]) % 2).astype(np.int32).reshape(-1, 1)
        span_is_power_of_two = float(np.log2(hi - lo)).is_integer()
        _assert_bit_identical(preds, target, b, lo, hi, pallas=span_is_power_of_two)
        if not span_is_power_of_two:
            compiled = label_score_histograms_pallas(jnp.asarray(preds), jnp.asarray(target), b, lo, hi,
                                                     interpret=True)
            assert not np.array_equal(np.asarray(compiled[0]), _plain(preds, target, b, lo, hi)[0])

    def test_matches_grid_index_and_clipped_count(self):
        rng = np.random.RandomState(14)
        x = (rng.rand(500) * 1.4 - 0.2).astype(np.float32)
        x[:3] = [np.nan, np.inf, -np.inf]
        got = sketches.grid_index(torch.from_numpy(x), 64, 0.0, 1.0)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sketches.grid_index(jnp.asarray(x), 64, 0.0, 1.0)))
        assert float(sketches.clipped_count(torch.from_numpy(x), 0.0, 1.0)) == float(
            jax_sketches.clipped_count(jnp.asarray(x), 0.0, 1.0))

    def test_wrapper_takes_a_cpu_tensor_to_the_plain_version(self):
        rng = np.random.RandomState(15)
        preds = torch.from_numpy(rng.rand(40, 3).astype(np.float32))
        target = torch.from_numpy(rng.randint(0, 2, (40, 3)))
        for got in (label_score_histograms_cuda(preds, target, 16, device="cpu"),
                    label_score_histograms(preds, target, 16)):
            for g, w in zip(got, label_score_histograms_torch(preds, target, 16)):
                assert torch.equal(g, w)
        assert _common.dispatch_count(_OP, "torch") == 2 and _common.launch_count(_OP) == 0

    def test_wrapper_rejects_what_it_does_not_take(self):
        preds, target = torch.rand(8, 2), torch.zeros(8, 2, dtype=torch.int32)
        with pytest.raises(ValueError, match="one shape"):
            label_score_histograms_cuda(preds, target[:, :1], 16, device="cpu")
        with pytest.raises(ValueError, match="num_bins"):
            label_score_histograms_cuda(preds, target, 0, device="cpu")
        with pytest.raises(ValueError, match="lo < hi"):
            label_score_histograms_cuda(preds, target, 16, 1.0, 1.0, device="cpu")
        with pytest.raises(ValueError, match="expected a tensor on"):
            label_score_histograms_cuda(preds, target.to("meta"), 16, device="cpu")

    def test_plain_version_runs_under_vmap(self):
        """The keyed path's per-row update: each row a length-1 batch inside
        ``torch.func.vmap``, the whole stack handed by the vmap rule to the
        batched wrapper, whose plain version counts it on the CPU."""
        rng = np.random.RandomState(16)
        preds = torch.from_numpy(rng.rand(30, 1, 1).astype(np.float32))
        target = torch.from_numpy(rng.randint(0, 2, (30, 1, 1)).astype(np.int32))
        pos, neg, clipped = torch.func.vmap(lambda p, t: label_score_histograms(p, t, 8))(preds, target)
        assert pos.shape == (30, 1, 8) and clipped.shape == (30,)
        want = label_score_histograms_torch(preds.reshape(-1, 1), target.reshape(-1, 1), 8)
        np.testing.assert_array_equal(pos.sum(0).numpy(), want[0].numpy())
        np.testing.assert_array_equal(neg.sum(0).numpy(), want[1].numpy())
        assert _common.dispatch_count(_OP, "torch") == 1  # the batched wrapper, once for the stack


class TestHistCurves:
    @staticmethod
    def _hists(seed, c=3, b=64, empty_label=False):
        rng = np.random.RandomState(seed)
        pos = rng.randint(0, 5, (c, b)).astype(np.float32)
        neg = rng.randint(0, 5, (c, b)).astype(np.float32)
        if empty_label:
            pos[0] = 0.0  # a class without positives: NaN in both packages
        return pos, neg

    @staticmethod
    def _close(got, want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6, equal_nan=True)

    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("empty_label", [False, True])
    def test_auroc_and_average_precision(self, seed, empty_label):
        pos, neg = self._hists(seed, empty_label=empty_label)
        tp, tn = torch.from_numpy(pos), torch.from_numpy(neg)
        self._close(sketches.hist_auroc(tp, tn), jax_sketches.hist_auroc(jnp.asarray(pos), jnp.asarray(neg)))
        self._close(sketches.hist_average_precision(tp, tn),
                    jax_sketches.hist_average_precision(jnp.asarray(pos), jnp.asarray(neg)))

    @pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 2.0)])
    def test_roc_and_precision_recall_curve(self, lo, hi):
        pos, neg = self._hists(4, c=2, b=32)
        tp, tn = torch.from_numpy(pos), torch.from_numpy(neg)
        for ours, theirs in ((sketches.hist_roc, jax_sketches.hist_roc),
                             (sketches.hist_precision_recall_curve, jax_sketches.hist_precision_recall_curve)):
            for g, w in zip(ours(tp, tn, lo, hi), theirs(jnp.asarray(pos), jnp.asarray(neg), lo, hi)):
                self._close(g, w)

    def test_binned_tp_fp_fn(self):
        rng = np.random.RandomState(5)
        preds, target = rng.rand(100, 3).astype(np.float32), rng.randint(0, 2, (100, 3))
        thresholds = np.linspace(0, 1, 11).astype(np.float32)
        got = binned_tp_fp_fn(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
        want = jax_binned_tp_fp_fn(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thresholds))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# the kernel's plan, its plumbing and the class-id label form
# --------------------------------------------------------------------------

PLAN_SHAPES = [(1024, 1000, 2048), (10000, 1, 2048), (4096, 3, 32), (1, 1, 2), (100000, 10, 2048), (64, 1001, 2048),
               (16, 4, 65536), (0, 5, 8)]


class TestHistogramPlan:
    @pytest.mark.parametrize("n,c,b", PLAN_SHAPES)
    def test_tiles_cover_every_column_once_within_the_budget(self, n, c, b):
        plan = histogram_plan(n, c, b, 132)
        if plan.mode == GLOBAL:
            assert tile_shared_bytes(1, b) > SHARED_BUDGET  # not even one column fits
            return
        assert plan.shared_bytes == tile_shared_bytes(plan.k, b) <= SHARED_BUDGET
        assert 2 * plan.k * b * 4 <= plan.shared_bytes
        columns = [col for tile in range(plan.tiles) for col in range(tile * plan.k, min(c, (tile + 1) * plan.k))]
        assert columns == list(range(c))
        assert plan.tiles == -(-c // plan.k) and 1 <= plan.k <= c
        rows = [row for chunk in range(plan.chunks)
                for row in range(chunk * plan.rows_per_chunk, min(n, (chunk + 1) * plan.rows_per_chunk))]
        assert len(rows) == n and (n == 0 or rows[-1] == n - 1)
        assert (plan.mode == STORE) == (plan.chunks == 1)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024 and plan.chunks <= 65535
        if plan.mode == ADD:  # one cooperative launch: every block resident at once, one per multiprocessor
            assert plan.tiles * plan.chunks <= 132

    @pytest.mark.parametrize("n,c,b,mode,k,tiles,chunks", [
        (1024, 1000, 2048, STORE, 8, 125, 1),  # 128 KB a block, one block per multiprocessor, no row chunks
        (10000, 1, 2048, ADD, 1, 1, 20),  # the binary stream: one tile, many row chunks
        (4096, 3, 32, ADD, 3, 1, 24),
        (1, 1, 2, STORE, 1, 1, 1),
        (100000, 10, 2048, ADD, 8, 2, 66),
        (64, 1001, 2048, STORE, 8, 126, 1),  # the last tile holds one column
        (16, 4, 65536, GLOBAL, 0, 0, 0),
        (0, 5, 8, STORE, 5, 1, 1),  # an empty batch still stores its zeroes
    ])
    def test_plans_of_the_paths_shapes(self, n, c, b, mode, k, tiles, chunks):
        plan = histogram_plan(n, c, b, 132)
        assert (plan.mode, plan.k, plan.tiles, plan.chunks) == (mode, k, tiles, chunks)

    def test_tile_width_is_a_multiple_of_8_where_c_and_the_budget_allow(self):
        for c, b in [(1000, 2048), (1001, 2048), (5000, 2048), (100_000, 16), (4096, 32), (8, 2048)]:
            assert histogram_plan(1024, c, b, 132).k % 8 == 0
        assert histogram_plan(1024, 7, 2048, 132).k == 7  # fewer than 8 columns: one tile
        assert histogram_plan(1024, 1000, 16384, 132).k == 1  # 128 KB a column: one column a tile

    def test_the_card_size_steers_the_plan(self):
        assert histogram_plan(10000, 1, 2048, 16).chunks == 16
        assert histogram_plan(1024, 64, 2048, 8).mode == STORE  # eight tiles fill a card of eight


@pytest.mark.parametrize("c,k,offset,want", [(1000, 8, 0, 4), (1000, 8, 4, 1), (1000, 8, 8, 1), (1000, 8, 16, 4),
                                             (1001, 8, 0, 1), (10, 8, 0, 1), (12, 6, 0, 1), (4, 4, 0, 4), (1, 1, 0, 1)])
def test_load_width_follows_c_k_and_the_alignment(c, k, offset, want):
    """16-byte loads take a row stride and a tile width that are multiples of 4 and 16-byte alignment."""
    assert load_width(c, k, (1 << 20) + offset) == want


class _FakeLibrary:
    """Stands in for the C entry: records each call and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


def _forbid(*_, **__):
    raise AssertionError("the CUDA path must not call this")


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()
    entries = []
    monkeypatch.setattr(bc, "kernel_function", lambda name, argtypes: entries.append(name) or lib)
    monkeypatch.setattr(bc, "current_stream_handle", lambda device: 1234)
    monkeypatch.setattr(bc, "sm_count", lambda device: 132)
    for name in ("zeros", "full", "zeros_like", "full_like"):
        monkeypatch.setattr(torch, name, _forbid)
    monkeypatch.setattr(torch.cuda, "device", _forbid)
    lib.entries = entries
    return lib


class TestCudaPathPlumbing:
    @pytest.mark.parametrize("n,c,b", [(64, 8, 16), (40, 3, 2048), (3000, 1, 2048), (16, 4, 65536)])
    @pytest.mark.parametrize("form", ["dense", "ids32", "ids64"])
    def test_one_library_call_no_fill_no_device_context(self, fake_library, n, c, b, form):
        """The library writes every output element itself: the wrapper
        allocates three ``torch.empty`` outputs, makes no ``torch.zeros``/
        ``torch.full`` call, enters no ``torch.cuda.device`` context, passes
        inputs that qualify as they are, and calls the C entry once with the
        plan, the label form, the device index and the stream handle."""
        preds = torch.rand(n, c)
        dense = form == "dense"
        labels = (torch.randint(0, 2, (n, c), dtype=torch.int32) if dense
                  else torch.randint(0, c, (n,), dtype=torch.int32 if form == "ids32" else torch.int64))
        pos, neg, clipped = bc._histograms_cuda(preds, labels, dense, b, 0.0, 1.0, torch.device("cpu"))
        assert fake_library.entries == ["label_score_histograms_launch"] and len(fake_library.calls) == 1
        args = fake_library.calls[0]
        assert len(args) == len(bc._ARGTYPES)
        plan = histogram_plan(n, c, b, 132)
        assert args[0] == preds.data_ptr() and args[1] == labels.data_ptr()  # no copy of inputs that qualify
        assert args[2] == {"dense": 0, "ids32": 4, "ids64": 8}[form]
        assert args[3:6] == (n, c, b) and args[6:9] == (0.0, 1.0, 1.0)
        assert args[9:13] == (plan.mode, plan.k, plan.chunks, plan.threads)
        assert args[13] == load_width(c, plan.k, preds.data_ptr() | (labels.data_ptr() if dense else 0))
        assert args[14:17] == (pos.data_ptr(), neg.data_ptr(), clipped.data_ptr()) and args[17:] == (None, 1234)
        for hist in (pos, neg):
            assert hist.shape == (c, b) and hist.dtype == torch.float32 and hist.is_contiguous()
        assert clipped.shape == () and clipped.dtype == torch.float32
        assert _common.launch_count(_OP) == 1

    def test_inputs_that_do_not_qualify_are_converted_once(self, fake_library):
        preds = torch.rand(6, 8, dtype=torch.float64).t()  # (8, 6), not contiguous, not float32
        target = torch.randint(0, 2, (8, 6)).float()
        bc._histograms_cuda(preds, target, True, 16, 0.0, 1.0, torch.device("cpu"))
        bc._histograms_cuda(preds, torch.arange(8, dtype=torch.int16), False, 16, 0.0, 1.0, torch.device("cpu"))
        for args, form in zip(fake_library.calls, (0, 4)):
            assert args[0] != preds.data_ptr() and args[2] == form and args[3:5] == (8, 6)

    @pytest.mark.parametrize("dense", [True, False])
    def test_a_failed_launch_raises_and_is_not_counted(self, fake_library, dense):
        """No fallback to the plain version: the error surfaces."""
        fake_library.err = 700
        labels = torch.ones(8, 2, dtype=torch.int32) if dense else torch.arange(8) % 2
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            bc._histograms_cuda(torch.rand(8, 2), labels, dense, 16, 0.0, 1.0, torch.device("cpu"))
        assert _common.launch_count(_OP) == 0 and _common.dispatch_count(_OP, "torch") == 0


def _onevsrest(preds, ids, b, lo=0.0, hi=1.0):
    got = _label_score_histograms_onevsrest(torch.from_numpy(preds), torch.from_numpy(ids), b, lo, hi)
    assert all(g.dtype == torch.float32 for g in got)
    return [g.numpy() for g in got]


class TestClassIdLabels:
    @pytest.mark.parametrize("n,c,b", [(64, 4, 16), (300, 10, 64), (1000, 3, 256), (7, 12, 2048)])
    @pytest.mark.parametrize("dtype", [np.int32, np.int64])
    def test_bit_identical_to_jax_on_the_one_hot(self, n, c, b, dtype):
        rng = np.random.RandomState(n + c + b)
        preds = (rng.rand(n, c) * 1.2 - 0.1).astype(np.float32)
        ids = rng.randint(0, c, n).astype(dtype)
        onehot = np.asarray(jax_to_onehot(jnp.asarray(ids), num_classes=c))
        assert onehot.shape == (n, c) and (onehot.sum(axis=1) == 1).all()
        got = _onevsrest(preds, ids, b)
        for ref in (label_score_histograms_xla(jnp.asarray(preds), jnp.asarray(onehot), b),
                    label_score_histograms_pallas(jnp.asarray(preds), jnp.asarray(onehot), b, interpret=True)):
            for g, w in zip(got, ref):
                np.testing.assert_array_equal(g, np.asarray(w))
        assert _common.dispatch_count(_OP, "torch") == 1 and _common.launch_count(_OP) == 0

    @pytest.mark.parametrize("dtype", [np.int32, np.int64])
    def test_an_id_outside_the_classes_is_an_all_negative_row_as_in_the_one_hot(self, dtype):
        """``to_onehot`` of both packages gives a label outside ``[0, C)``
        an all-zero row, so every score of that row counts as negative."""
        rng = np.random.RandomState(21)
        preds = rng.rand(40, 5).astype(np.float32)
        ids = rng.randint(-2, 8, 40).astype(dtype)
        onehot = np.array(jax_to_onehot(jnp.asarray(ids), num_classes=5))
        assert ((ids < 0) | (ids >= 5)).any() and (onehot[(ids < 0) | (ids >= 5)] == 0).all()
        got = _onevsrest(preds, ids, 32)
        for g, w in zip(got, label_score_histograms_xla(jnp.asarray(preds), jnp.asarray(onehot), 32)):
            np.testing.assert_array_equal(g, np.asarray(w))
        dense = label_score_histograms(torch.from_numpy(preds), torch.from_numpy(onehot), 32)
        for g, w in zip(got, dense):
            np.testing.assert_array_equal(g, w.numpy())
        assert got[0].sum() == ((ids >= 0) & (ids < 5)).sum() and got[0].sum() + got[1].sum() == preds.size

    def test_custom_range_and_other_integer_dtypes(self):
        rng = np.random.RandomState(22)
        preds = (rng.randn(200, 3) * 3).astype(np.float32)
        ids = rng.randint(0, 3, 200)
        want = label_score_histograms_xla(jnp.asarray(preds), jax_to_onehot(jnp.asarray(ids), num_classes=3), 32,
                                          -2.0, 2.0)
        for dtype in (np.uint8, np.int16, np.int64):
            for g, w in zip(_onevsrest(preds, ids.astype(dtype), 32, -2.0, 2.0), want):
                np.testing.assert_array_equal(g, np.asarray(w))

    def test_rejects_what_it_does_not_take(self):
        preds = torch.rand(8, 3)
        with pytest.raises(ValueError, match="class ids of shape"):
            _label_score_histograms_onevsrest(preds, torch.zeros(8, 3, dtype=torch.int64), 16)
        with pytest.raises(ValueError, match="class ids of shape"):
            _label_score_histograms_onevsrest(preds, torch.zeros(7, dtype=torch.int64), 16)
        with pytest.raises(ValueError, match="num_bins"):
            _label_score_histograms_onevsrest(preds, torch.zeros(8, dtype=torch.int64), 0)
        with pytest.raises(ValueError, match="expected a tensor on"):
            _label_score_histograms_onevsrest(preds, torch.zeros(8, dtype=torch.int64, device="meta"), 16)

    def test_plain_version_runs_under_vmap(self):
        rng = np.random.RandomState(23)
        preds = torch.from_numpy(rng.rand(30, 1, 4).astype(np.float32))
        ids = torch.from_numpy(rng.randint(0, 4, (30, 1)))
        pos, neg, clipped = torch.func.vmap(lambda p, t: _label_score_histograms_onevsrest(p, t, 8))(preds, ids)
        assert pos.shape == (30, 4, 8) and clipped.shape == (30,)
        want = _label_score_histograms_onevsrest(preds.reshape(-1, 4), ids.reshape(-1), 8)
        np.testing.assert_array_equal(pos.sum(0).numpy(), want[0].numpy())
        np.testing.assert_array_equal(neg.sum(0).numpy(), want[1].numpy())
        assert _common.dispatch_count(_OP, "torch") == 2  # the flat call and the batched wrapper, once for the stack


class TestBatchedForm:
    """B5 under ``jax.vmap``: ``pallas_call``'s batching rule runs the
    kernel over the stack, one ``(N, C)`` slice at a time."""

    @staticmethod
    def _stack(seed, r, n, c, form):
        rng = np.random.RandomState(seed)
        preds = (rng.rand(r, n, c) * 1.2 - 0.1).astype(np.float32)  # some scores outside [0, 1]
        if form == "dense":
            return preds, rng.randint(0, 2, (r, n, c)).astype(np.int32)
        return preds, rng.randint(-1, c + 1, (r, n)).astype(np.int64 if form == "ids64" else np.int32)

    @pytest.mark.parametrize("r,n,c,b", [(33, 1, 1, 2048), (17, 1, 10, 2048), (5, 9, 3, 64), (4, 0, 3, 16)])
    @pytest.mark.parametrize("form", ["dense", "ids32", "ids64"])
    def test_plain_batched_equals_the_vmapped_jax_kernel(self, r, n, c, b, form):
        preds, labels = self._stack(r + n + c, r, n, c, form)
        dense = labels if form == "dense" else (labels[..., None] == np.arange(c)).astype(np.int32)
        got = label_score_histograms_batched_torch(torch.from_numpy(preds), torch.from_numpy(labels), b)
        assert got[0].shape == got[1].shape == (r, c, b) and got[2].shape == (r,)
        assert all(g.dtype == torch.float32 for g in got)
        vmapped = jax.vmap(lambda p, t: label_score_histograms_pallas(p, t, b, interpret=True))
        for g, w in zip(got, vmapped(jnp.asarray(preds), jnp.asarray(dense))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for i in range(r):  # and the _xla formulation, slice by slice
            for g, w in zip(got, label_score_histograms_xla(jnp.asarray(preds[i]), jnp.asarray(dense[i]), b)):
                np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))

    def test_nan_inf_and_subnormals_as_the_single_form_counts_them(self):
        x = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, -1e-39, 1.0, 0.5, 2.0, -1.0], np.float32)
        preds = torch.from_numpy(x).reshape(-1, 1, 1)
        labels = torch.from_numpy(np.arange(x.size) % 2).int().reshape(-1, 1, 1)
        got = label_score_histograms_batched_torch(preds, labels, 16)
        for i in range(x.size):
            for g, w in zip(got, label_score_histograms_torch(preds[i], labels[i], 16)):
                assert torch.equal(g[i], w)

    def test_wrapper_takes_a_cpu_stack_to_the_plain_version_and_rejects_what_it_does_not_take(self):
        preds, labels = (torch.from_numpy(x) for x in self._stack(3, 6, 2, 4, "ids64"))
        got = label_score_histograms_batched_cuda(preds, labels, 32, device="cpu")
        for g, w in zip(got, label_score_histograms_batched_torch(preds, labels, 32)):
            assert torch.equal(g, w)
        assert _common.dispatch_count(_OP, "torch") == 1 and _common.launch_count(_OP) == 0
        with pytest.raises(ValueError, match="one shape"):
            label_score_histograms_batched_cuda(preds, torch.zeros(6, 2, 3, dtype=torch.int32), 32, device="cpu")
        with pytest.raises(ValueError, match="class ids of shape"):
            label_score_histograms_batched_cuda(preds, labels[:, :1], 32, device="cpu")
        with pytest.raises(ValueError, match="num_bins"):
            label_score_histograms_batched_cuda(preds, labels, 0, device="cpu")
        with pytest.raises(ValueError, match="lo < hi"):
            label_score_histograms_batched_cuda(preds, labels, 32, 1.0, 0.0, device="cpu")

    @pytest.mark.parametrize("ids", [False, True])
    def test_the_vmap_rule_hands_a_nested_vmap_to_one_call(self, ids):
        """Two nested vmaps: one dispatch of the batched wrapper over the
        flattened (6 * 5) stack, as ``test_stacked_confmat_under_vmap_dispatch_once_for_the_whole_stack``
        holds B2's rule."""
        preds, labels = (torch.from_numpy(x) for x in self._stack(4, 30, 1, 4, "ids64" if ids else "dense"))
        preds, labels = preds.reshape((6, 5) + preds.shape[1:]), labels.reshape((6, 5) + labels.shape[1:])
        fn = _label_score_histograms_onevsrest if ids else label_score_histograms
        got = torch.func.vmap(torch.func.vmap(lambda p, t: fn(p, t, 16)))(preds, labels)
        want = label_score_histograms_batched_torch(preds.reshape(30, 1, 4), labels.reshape((30,) + labels.shape[2:]),
                                                    16)
        for g, w in zip(got, want):
            assert g.shape == (6, 5) + w.shape[1:] and torch.equal(g.reshape(w.shape), w)
        assert _common.dispatch_count(_OP, "torch") == 1

    def test_the_vmap_rule_broadcasts_an_unbatched_label_tensor(self):
        rng = np.random.RandomState(5)
        preds = torch.from_numpy(rng.rand(7, 3, 2).astype(np.float32))
        labels = torch.from_numpy(rng.randint(0, 2, (3, 2)).astype(np.int32))
        got = torch.func.vmap(lambda p: label_score_histograms(p, labels, 8))(preds)
        want = label_score_histograms_batched_torch(preds, labels.expand(7, 3, 2), 8)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert _common.dispatch_count(_OP, "torch") == 1

    @pytest.mark.parametrize("n,c,b,mode,k,tiles,threads", [
        (1, 1, 2048, STORE, 1, 1, 256),  # the keyed binary rows: one block a slice stores 16 KB
        (1, 10, 2048, STORE, 10, 1, 1024),  # the keyed 10-class rows: one tile of every column
        (1024, 1000, 2048, STORE, 8, 125, 1024),  # a bootstrap's resamples: the single form's tiles
        (5, 7, 2048, STORE, 7, 1, 1024),
        (0, 7, 2048, STORE, 7, 1, 1024),
        (64, 1001, 2048, STORE, 8, 126, 1024),
        (16, 4, 65536, GLOBAL, 0, 0, 0),
        (1, 1, 1000, STORE, 1, 1, 128),
    ])
    def test_plans_of_the_paths_stacks(self, n, c, b, mode, k, tiles, threads):
        plan = batched_histogram_plan(n, c, b)
        assert (plan.mode, plan.k, plan.tiles, plan.threads) == (mode, k, tiles, threads)
        if mode == STORE:
            assert plan.chunks == 1 and plan.rows_per_chunk == n
            assert plan.shared_bytes == tile_shared_bytes(k, b) <= SHARED_BUDGET

    @pytest.mark.parametrize("r,n,c,b", [(4096, 1, 1, 2048), (20, 64, 8, 2048), (7, 3, 5, 65536)])
    @pytest.mark.parametrize("form", ["dense", "ids32", "ids64"])
    def test_the_cuda_path_makes_one_library_call(self, fake_library, r, n, c, b, form):
        """A stack goes to the batched C entry in one call: three
        ``torch.empty`` outputs of ``(R, C, B)``, ``(R, C, B)`` and ``(R,)``,
        no fill, inputs that qualify passed as they are, the plan's mode, tile
        width and threads; a failed launch raises and counts nothing."""
        preds, labels = (torch.from_numpy(x) for x in self._stack(r, r, n, c, form))
        pos, neg, clipped = bc._histograms_cuda(preds, labels, form == "dense", b, 0.0, 1.0, torch.device("cpu"))
        assert fake_library.entries == ["label_score_histograms_batched_launch"] and len(fake_library.calls) == 1
        args = fake_library.calls[0]
        plan = batched_histogram_plan(n, c, b)
        assert len(args) == len(bc._BATCHED_ARGTYPES)
        assert args[0] == preds.data_ptr() and args[1] == labels.data_ptr()
        assert args[2] == {"dense": 0, "ids32": 4, "ids64": 8}[form] and args[3:7] == (r, n, c, b)
        assert args[7:10] == (0.0, 1.0, 1.0) and args[10:13] == (plan.mode, plan.k, plan.threads)
        assert args[14:17] == (pos.data_ptr(), neg.data_ptr(), clipped.data_ptr()) and args[17:] == (None, 1234)
        assert pos.shape == neg.shape == (r, c, b) and clipped.shape == (r,)
        assert _common.launch_count(_OP) == 1
        fake_library.err = 700
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            bc._histograms_cuda(preds, labels, form == "dense", b, 0.0, 1.0, torch.device("cpu"))
        assert _common.launch_count(_OP) == 1
