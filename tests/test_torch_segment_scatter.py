"""The port's segment-scatter kernels (B3, B4) against the JAX package's.

The plain PyTorch versions (``segment_scatter_{add,max,min}_torch``) are held
against the JAX package's ``_xla`` formulations and its Pallas kernels in
interpret mode, on the same numpy inputs, mirroring ``TestSegmentScatterKernel``
and ``TestExtremalScatterKernel`` of ``tests/kernels/test_pallas_kernels.py``.
Counts and extrema are exact; so are sums of integer-valued rows. Float sums
hold ``rtol=1e-6, atol=1e-8`` against ``_xla`` (the tolerance of the JAX
package's keyed state parity: the two add in different orders) and
``rtol=1e-5, atol=1e-5`` against the Pallas kernel (the JAX package's own
Pallas-vs-XLA tolerance: the one-hot contraction rounds differently). Shapes
above the Pallas kernels' VMEM gates (S > 1024, D > 511 for sums or > 16 for
extrema) are held against ``_xla`` only. The wrappers run the plain version
for a CPU tensor and launch nothing; the cases that launch the CUDA kernels
live in ``tests/test_torch_card.py``. The CUDA path's plumbing (one call
into the C library, outputs left unfilled for it, the vector width, the
32-bit size limit, a failed launch raising) is tested on the CPU against a
stand-in for the library.

The merge (``segment_merge_{torch,cuda}``) replaces no JAX kernel: its plain
version is held bit for bit against the per-leaf route the keyed update took
through B3's and B4's plain versions before it (``_per_leaf_route``), over
int32 and float32 leaves with integer-valued rows, wherever that route was
exact; where the two differ (an int32 sum past 2^24, a signed zero or a NaN
state meeting an extremum) ``tests/test_torch_multitenant.py`` holds the
keyed update against the JAX package's.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.kernels.segment_scatter import (
    segment_scatter_add_pallas,
    segment_scatter_add_xla,
    segment_scatter_max_pallas,
    segment_scatter_max_xla,
    segment_scatter_min_pallas,
    segment_scatter_min_xla,
)
from metrics_tpu_torch.kernels import _common
from metrics_tpu_torch.kernels import segment_scatter as ss
from metrics_tpu_torch.kernels.segment_scatter import (
    segment_merge_cuda,
    segment_merge_torch,
    segment_scatter_add_cuda,
    segment_scatter_add_torch,
    segment_scatter_max_cuda,
    segment_scatter_max_torch,
    segment_scatter_min_cuda,
    segment_scatter_min_torch,
    vector_width,
)

_TORCH = {"add": segment_scatter_add_torch, "max": segment_scatter_max_torch, "min": segment_scatter_min_torch}
_CUDA = {"add": segment_scatter_add_cuda, "max": segment_scatter_max_cuda, "min": segment_scatter_min_cuda}
_XLA = {"add": segment_scatter_add_xla, "max": segment_scatter_max_xla, "min": segment_scatter_min_xla}
_PALLAS = {"add": segment_scatter_add_pallas, "max": segment_scatter_max_pallas, "min": segment_scatter_min_pallas}
#: the Pallas kernels' VMEM gates (metrics_tpu/kernels/segment_scatter.py:56-59,177)
_PALLAS_MAX_S, _PALLAS_MAX_D = 1024, {"add": 511, "max": 16, "min": 16}


@pytest.fixture(autouse=True)
def _zero_counters():
    _common.reset_dispatch_counters()
    yield
    _common.reset_dispatch_counters()


def _plain(op, rows, ids, s):
    sums, counts = _TORCH[op](torch.from_numpy(rows), torch.from_numpy(ids), s)
    assert sums.dtype == torch.float32 and counts.dtype == torch.int32
    assert sums.shape == (s, rows.shape[1]) and counts.shape == (s,)
    return sums.numpy(), counts.numpy()


def _assert_exact(got, want):
    """Equal values, NaN equal to NaN, and the same sign of zero (the sign
    bit of a NaN carries nothing and is not compared)."""
    want = np.asarray(want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got) & ~np.isnan(got), np.signbit(want) & ~np.isnan(want))


def _pallas_takes(op, s, d):
    return s <= _PALLAS_MAX_S and d <= _PALLAS_MAX_D[op]


class TestSegmentScatterAdd:
    @pytest.mark.parametrize(
        "r,s,d", [(100, 8, 4), (700, 512, 8), (7, 3, 1), (256, 128, 16), (300, 64, 40), (40, 8, 511),
                  (200, 1025, 6), (1, 1, 1), (64, 1, 6)]
    )
    def test_integer_data_bit_identical(self, r, s, d):
        rng = np.random.RandomState(r * 7 + s + d)
        rows = rng.randint(0, 5, (r, d)).astype(np.float32)
        ids = rng.randint(0, s, r)
        sums, counts = _plain("add", rows, ids, s)
        want = segment_scatter_add_xla(jnp.asarray(rows), jnp.asarray(ids), s)
        _assert_exact(sums, want[0])
        _assert_exact(counts, want[1])
        if _pallas_takes("add", s, d):
            want = segment_scatter_add_pallas(jnp.asarray(rows), jnp.asarray(ids), s, interpret=True)
            _assert_exact(sums, want[0])
            _assert_exact(counts, want[1])

    @pytest.mark.parametrize("seed", range(5))
    def test_float_data(self, seed):
        rng = np.random.RandomState(seed)
        r, s, d = rng.randint(1, 400), rng.randint(1, 64), rng.choice([1, 6, 40])
        rows = rng.randn(r, d).astype(np.float32)
        ids = rng.randint(-2, s + 2, r)  # includes invalid ids
        sums, counts = _plain("add", rows, ids, s)
        x_sums, x_counts = segment_scatter_add_xla(jnp.asarray(rows), jnp.asarray(ids), s)
        np.testing.assert_allclose(sums, np.asarray(x_sums), rtol=1e-6, atol=1e-8)
        _assert_exact(counts, x_counts)
        p_sums, p_counts = segment_scatter_add_pallas(jnp.asarray(rows), jnp.asarray(ids), s, interpret=True)
        np.testing.assert_allclose(sums, np.asarray(p_sums), rtol=1e-5, atol=1e-5)
        _assert_exact(counts, p_counts)

    @pytest.mark.parametrize("dtype", [np.float32, np.int32])
    def test_rows_go_through_float32(self, dtype):
        rng = np.random.RandomState(3)
        rows = rng.randint(-3, 3, (64, 6)).astype(dtype)
        ids = rng.randint(0, 8, 64)
        sums, counts = _plain("add", rows, ids, 8)
        want = segment_scatter_add_xla(jnp.asarray(rows), jnp.asarray(ids), 8)
        assert want[0].dtype == jnp.float32
        _assert_exact(sums, want[0])
        _assert_exact(counts, want[1])

    def test_empty_batch(self):
        sums, counts = _plain("add", np.zeros((0, 3), np.float32), np.zeros((0,), np.int64), 4)
        want = segment_scatter_add_pallas(jnp.zeros((0, 3), jnp.float32), jnp.zeros((0,), jnp.int32), 4,
                                          interpret=True)
        _assert_exact(sums, want[0])
        _assert_exact(counts, want[1])

    @pytest.mark.parametrize("s", [4, 1025])
    def test_invalid_ids_are_dropped(self, s):
        """-1, S and S+7 contribute to neither output, as the discard bucket drops them."""
        rows = np.ones((10, 2), np.float32)
        ids = np.asarray([-5, -1, 0, 1, 2, 3, s, s + 7, 99 + s, 2**30])
        sums, counts = _plain("add", rows, ids, s)
        want = segment_scatter_add_xla(jnp.asarray(rows), jnp.asarray(ids), s)
        _assert_exact(sums, want[0])
        _assert_exact(counts, want[1])
        assert counts.sum() == 4
        if _pallas_takes("add", s, 2):
            _assert_exact(sums, segment_scatter_add_pallas(jnp.asarray(rows), jnp.asarray(ids), s, interpret=True)[0])


class TestSegmentScatterExtremal:
    @pytest.mark.parametrize("op", ["max", "min"])
    @pytest.mark.parametrize("seed", range(5))
    def test_float_fuzz_bit_identical(self, op, seed):
        rng = np.random.RandomState(100 + seed)
        r, s, d = rng.randint(1, 400), rng.randint(1, 64), rng.randint(1, 8)
        rows = rng.randn(r, d).astype(np.float32)
        ids = rng.randint(-2, s + 2, r)  # includes invalid ids
        ext, counts = _plain(op, rows, ids, s)
        for want in (_XLA[op](jnp.asarray(rows), jnp.asarray(ids), s),
                     _PALLAS[op](jnp.asarray(rows), jnp.asarray(ids), s, interpret=True)):
            _assert_exact(ext, want[0])
            _assert_exact(counts, want[1])

    @pytest.mark.parametrize("op", ["max", "min"])
    @pytest.mark.parametrize("r,s,d", [(1, 1, 1), (200, 16, 3), (64, 8, 16), (300, 1025, 1), (50, 6, 40)])
    def test_integer_data_bit_identical(self, op, r, s, d):
        rng = np.random.RandomState(r + s + d)
        rows = rng.randint(-(2**20), 2**20, (r, d)).astype(np.float32)
        ids = rng.randint(0, s, r)
        ext, counts = _plain(op, rows, ids, s)
        _assert_exact(ext, _XLA[op](jnp.asarray(rows), jnp.asarray(ids), s)[0])
        if _pallas_takes(op, s, d):
            want = _PALLAS[op](jnp.asarray(rows), jnp.asarray(ids), s, interpret=True)
            _assert_exact(ext, want[0])
            _assert_exact(counts, want[1])

    @pytest.mark.parametrize("op", ["max", "min"])
    def test_nan_signed_zero_and_inf_rows(self, op):
        """A NaN row makes its segment NaN; +0.0 is above -0.0 in either row
        order (XLA's result does not depend on the order); ±inf pick as
        numbers; a segment with no row keeps the identity."""
        f = np.finfo(np.float32)
        cases = [  # (row value, segment)
            (np.nan, 0), (1.0, 0), (2.0, 1), (np.nan, 1),
            (-0.0, 2), (0.0, 2), (0.0, 3), (-0.0, 3), (-0.0, 4), (0.0, 5),
            (np.inf, 6), (1.0, 6), (-np.inf, 7), (-1.0, 7), (np.inf, 8), (-np.inf, 8),
            (f.max, 9), (f.min, 9), (f.tiny, 10), (-f.tiny, 10),
        ]
        rows = np.asarray([[v] for v, _ in cases], np.float32)
        ids = np.asarray([sid for _, sid in cases])
        s = 12  # segment 11 gets no row
        ext, counts = _plain(op, rows, ids, s)
        for want in (_XLA[op](jnp.asarray(rows), jnp.asarray(ids), s),
                     _PALLAS[op](jnp.asarray(rows), jnp.asarray(ids), s, interpret=True)):
            _assert_exact(ext, want[0])
            _assert_exact(counts, want[1])
        assert np.isnan(ext[:2, 0]).all()
        zero_sign = op == "min"
        assert (ext[2:4, 0] == 0).all() and (np.signbit(ext[2:4, 0]) == zero_sign).all()
        assert ext[11, 0] == (-np.inf if op == "max" else np.inf) and counts[11] == 0

    @pytest.mark.parametrize("op", ["max", "min"])
    def test_empty_segments_hold_the_identity(self, op):
        rows = np.asarray([[1.5], [-2.5]], np.float32)
        ids = np.asarray([0, 2])
        ext, counts = _plain(op, rows, ids, 4)
        _assert_exact(ext, _XLA[op](jnp.asarray(rows), jnp.asarray(ids), 4)[0])
        identity = -np.inf if op == "max" else np.inf
        np.testing.assert_array_equal(ext[[1, 3], 0], [identity, identity])
        np.testing.assert_array_equal(counts, [1, 0, 1, 0])

    @pytest.mark.parametrize("op", ["max", "min"])
    @pytest.mark.parametrize("s", [4, 1025])
    def test_invalid_ids_are_dropped(self, op, s):
        rows = np.random.RandomState(s).randn(10, 2).astype(np.float32) * 100
        ids = np.asarray([-5, -1, 0, 1, 2, 3, 3, s, s + 7, 2**30])
        ext, counts = _plain(op, rows, ids, s)
        want = _XLA[op](jnp.asarray(rows), jnp.asarray(ids), s)
        _assert_exact(ext, want[0])
        _assert_exact(counts, want[1])
        assert counts.sum() == 5

    @pytest.mark.parametrize("op", ["max", "min"])
    def test_int32_rows_go_through_float32(self, op):
        rows = np.asarray([[3], [1], [4], [0], [2]], np.int32)
        ids = np.asarray([0, 0, 1, 1, 2])
        ext, counts = _plain(op, rows, ids, 3)
        want = _XLA[op](jnp.asarray(rows), jnp.asarray(ids), 3)
        assert want[0].dtype == jnp.float32
        _assert_exact(ext, want[0])
        _assert_exact(counts, want[1])

    @pytest.mark.parametrize("op", ["max", "min"])
    def test_empty_batch(self, op):
        ext, counts = _plain(op, np.zeros((0, 2), np.float32), np.zeros((0,), np.int64), 3)
        _assert_exact(ext, _XLA[op](jnp.zeros((0, 2), jnp.float32), jnp.zeros((0,), jnp.int32), 3)[0])
        assert counts.sum() == 0


@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_cpu_tensors_run_the_plain_version_and_launch_nothing(op):
    rng = np.random.RandomState(9)
    rows, ids = torch.from_numpy(rng.randn(32, 3).astype(np.float32)), torch.from_numpy(rng.randint(-1, 6, 32))
    got = _CUDA[op](rows, ids, 5, device="cpu")
    want = _TORCH[op](rows, ids, 5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    name = f"segment_scatter_{op}"
    assert _common.launch_count(name) == 0
    assert _common.dispatch_count(name, "torch") == 1


@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_cpu_tensors_raise_under_the_default_cuda_device(op):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _CUDA[op](torch.zeros(4, 2), torch.zeros(4, dtype=torch.int64), 3)


@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_cpu_tensors_raise_under_an_indexed_cuda_device(op):
    """A resolved ``cuda:0`` skips the availability probe; CPU tensors are
    then not on the device asked for, and the wrapper raises all the same."""
    with pytest.raises((RuntimeError, ValueError)):
        _CUDA[op](torch.zeros(4, 2), torch.zeros(4, dtype=torch.int64), 3, device=torch.device("cuda", 0))
    assert _common.launch_count(f"segment_scatter_{op}") == 0


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize(
    "rows,ids,s,error",
    [
        (torch.zeros(4), torch.zeros(4, dtype=torch.int64), 3, ValueError),
        (torch.zeros(4, 2), torch.zeros(3, dtype=torch.int64), 3, ValueError),
        (torch.zeros(4, 2), torch.zeros(4, 1, dtype=torch.int64), 3, ValueError),
        (torch.zeros(4, 2), torch.zeros(4, dtype=torch.int64), 0, ValueError),
        (torch.zeros(4, 2), torch.zeros(4), 3, TypeError),
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(op, rows, ids, s, error):
    with pytest.raises(error):
        _CUDA[op](rows, ids, s, device="cpu")


@pytest.mark.parametrize(
    "d,offset,want",
    [(40, 0, 4), (8, 0, 4), (4, 0, 4), (0, 0, 4), (40, 8, 2), (4, 8, 2), (6, 0, 2), (2, 0, 2), (2, 8, 2),
     (40, 4, 1), (6, 4, 1), (2, 4, 1), (3, 0, 1), (1, 0, 1), (40, 12, 1)],
)
def test_vector_width_follows_d_and_the_alignment(d, offset, want):
    """float4 takes D % 4 == 0 and 16-byte alignment, float2 D even and 8 bytes, else scalars."""
    assert vector_width(d, (1 << 20) + offset) == want


@pytest.mark.parametrize("offset,want", [(0, 4), (1, 1), (2, 2), (3, 1), (4, 4)])
def test_vector_width_of_a_view_into_a_buffer(offset, want):
    """The OR of the rows' and the sums' pointers is as aligned as the less aligned of the two."""
    buf = torch.zeros(64 * 8 + 8)
    assert buf.data_ptr() % 16 == 0
    rows = buf[offset:offset + 64 * 8].view(64, 8)
    sums = torch.empty(10, 8)
    assert vector_width(8, rows.data_ptr() | sums.data_ptr()) == want
    assert vector_width(8, sums.data_ptr() | rows.data_ptr()) == want


@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_wrappers_reject_rows_past_the_32_bit_index(op, monkeypatch):
    """R * max(D, 1) must stay below the kernels' 32-bit index limit (2**31;
    lowered here so that no large tensor is needed)."""
    monkeypatch.setattr(ss, "_MAX_ITEMS", 64)
    ids = torch.zeros(16, dtype=torch.int64)
    with pytest.raises(ValueError, match="32 bits"):
        _CUDA[op](torch.zeros(16, 4), ids, 3, device="cpu")
    with pytest.raises(ValueError, match="32 bits"):
        _CUDA[op](torch.zeros(64, 0), torch.zeros(64, dtype=torch.int64), 3, device="cpu")
    sums, counts = _CUDA[op](torch.zeros(15, 4), ids[:15], 3, device="cpu")
    assert int(counts.sum()) == 15


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
    monkeypatch.setattr(ss, "kernel_function", lambda name, argtypes: entries.append(name) or lib)
    monkeypatch.setattr(ss, "current_stream_handle", lambda device: 1234)
    for name in ("zeros", "full", "zeros_like", "full_like"):
        monkeypatch.setattr(torch, name, _forbid)
    monkeypatch.setattr(torch.cuda, "device", _forbid)
    lib.entries = entries
    return lib


@pytest.mark.parametrize("op,code", [("add", 0), ("max", 1), ("min", 2)])
@pytest.mark.parametrize("d,offset", [(40, 0), (40, 1), (6, 0), (1, 0)])
@pytest.mark.parametrize("ids_dtype", [torch.int64, torch.int32])
def test_cuda_path_makes_one_library_call_and_no_fill(fake_library, op, code, d, offset, ids_dtype):
    """The library fills the outputs itself: the wrapper allocates them with
    ``torch.empty`` only, makes no ``torch.zeros``/``torch.full`` call and
    enters no ``torch.cuda.device`` context, and calls the C entry once with
    the device index, the stream handle and the vector width."""
    buf = torch.ones(8 * d + offset)
    rows, ids = buf[offset:offset + 8 * d].view(8, d), torch.arange(8).to(ids_dtype)
    name = f"segment_scatter_{op}"
    out, counts = ss._scatter_cuda(name, code, rows, ids, 10, torch.device("cpu"))
    assert fake_library.entries == ["segment_scatter_launch"] and len(fake_library.calls) == 1
    args = fake_library.calls[0]
    width = vector_width(d, rows.data_ptr() | out.data_ptr()) if op == "add" else 1
    assert args[0] == rows.data_ptr() and args[1] == ids.data_ptr()
    assert args[2:8] == (8, d, 10, ids.element_size(), code, width)
    assert args[8] == out.data_ptr() and args[9] == counts.data_ptr() and args[11] == 1234
    assert out.shape == (10, d) and out.dtype == torch.float32 and out.is_contiguous()
    assert counts.shape == (10,) and counts.dtype == torch.int32
    assert _common.launch_count(name) == 1


@pytest.mark.parametrize("op,code", [("add", 0), ("max", 1)])
def test_a_failed_launch_raises_and_is_not_counted(fake_library, op, code):
    fake_library.err = 700
    name = f"segment_scatter_{op}"
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ss._scatter_cuda(name, code, torch.ones(8, 4), torch.arange(8), 10, torch.device("cpu"))
    assert _common.launch_count(name) == 0


# --------------------------------------------------------------------------
# the merge
# --------------------------------------------------------------------------


def _per_leaf_route(leaves, ids, s):
    """The keyed update's route before the merge: each sum leaf's ``rows -
    default`` through B3's plain version in float32, cast back and added to
    the state; each extremal leaf through B4's plain version, then
    ``torch.maximum``/``minimum`` against the state where the segment has
    rows; the counts of the first call; the dropped ids summed."""
    outs, counts = [], None
    for rows, state, default, op in leaves:
        r, d = rows.shape[0], default.numel()
        if op == "sum":
            sums, c = segment_scatter_add_torch((rows - default).reshape(r, d).to(torch.float32), ids, s)
            outs.append(state + sums.reshape(state.shape).to(state.dtype))
        else:
            seg, c = _TORCH["max" if op == "max" else "min"](rows.reshape(r, d).to(torch.float32), ids, s)
            pick = torch.maximum if op == "max" else torch.minimum
            has_rows = (c > 0).reshape((s,) + (1,) * (state.ndim - 1))
            outs.append(torch.where(has_rows, pick(state, seg.reshape(state.shape).to(state.dtype)), state))
        counts = c if counts is None else counts
    return outs, counts, torch.sum((ids < 0) | (ids >= s)).to(torch.int32)


def _rows(rng, r, shape, dtype, layout):
    """Integer-valued ``(r, *shape)`` rows in [-3, 3], laid out ``"dense"``,
    ``"broadcast"`` (one row expanded: stride 0, as Accuracy's ``correct`` and
    ``total`` rows) or ``"strided"`` (a slice of an ``(r, 4, D)`` buffer, as
    B1's batched output)."""
    d = int(np.prod(shape, dtype=np.int64))
    if layout == "broadcast":
        return torch.from_numpy(rng.randint(-3, 4, shape).astype(np.float32)).to(dtype).expand((r,) + shape)
    if layout == "strided":
        buf = torch.from_numpy(rng.randint(-3, 4, (r, 4, d)).astype(np.float32)).to(dtype)
        return buf[:, 2, :].reshape((r,) + shape) if len(shape) == 1 else buf[:, 2, :]
    return torch.from_numpy(rng.randint(-3, 4, (r,) + shape).astype(np.float32)).to(dtype)


def _merge_leaves(rng, r, s, dtype, specials=True):
    """One leaf per (op, shape, layout): states integer-valued and non-zero,
    defaults non-zero; the float extrema's rows hold NaN, +0.0 and -0.0."""
    leaves = []
    for op in ("sum", "max", "min"):
        for shape, layout in (((), "dense"), ((), "broadcast"), ((10,), "strided"), ((2, 3), "dense"),
                              ((10,), "broadcast")):
            rows = _rows(rng, r, shape, dtype, layout)
            if specials and op != "sum" and dtype == torch.float32 and layout == "dense" and r >= 3:
                rows = rows.clone()
                rows[0] = float("nan")
                rows[1] = -0.0
                rows[2] = 0.0
            state = torch.from_numpy(rng.choice([-5, -2, 1, 4, 7], (s,) + shape).astype(np.float32)).to(dtype)
            default = torch.full(shape, 2, dtype=dtype)
            leaves.append((rows, state, default, op))
    return leaves


def _merge_ids(rng, r, s, dtype):
    """Ids over the segments and the padding band near S - 1, with ids below
    0, at S and far past it."""
    ids = rng.randint(0, s, r)
    bad = rng.rand(r) < 0.2
    ids[bad] = rng.choice([-7, -1, s, s + 5, 2**30], bad.sum())
    return torch.from_numpy(ids).to(dtype)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("ids_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("r,s", [(64, 10), (300, 7), (5, 1), (1, 3), (0, 4)])
def test_merge_plain_equals_the_per_leaf_route_bit_for_bit(dtype, ids_dtype, r, s):
    """Sums with non-zero defaults, extrema with NaN and signed-zero rows, rows
    dense, broadcast and strided, ids dropped and in the band: the new states,
    the counts and the dropped count equal the per-leaf route's bit for bit,
    and a segment without rows keeps its state."""
    rng = np.random.RandomState(r * 31 + s + (dtype == torch.int32))
    leaves = _merge_leaves(rng, r, s, dtype)
    ids = _merge_ids(rng, r, s, ids_dtype)
    outs, counts, invalid = segment_merge_torch(leaves, ids, s)
    want_outs, want_counts, want_invalid = _per_leaf_route(leaves, ids, s)
    assert len(outs) == len(leaves)
    for (_, state, _, op), got, want in zip(leaves, outs, want_outs):
        assert got.dtype == state.dtype and got.shape == state.shape, op
        _assert_exact(got.numpy(), want.numpy())
        empty = (want_counts == 0).numpy()
        _assert_exact(got.numpy()[empty], state.numpy()[empty])
    assert counts.dtype == torch.int32 and torch.equal(counts, want_counts)
    assert invalid.dtype == torch.int32 and invalid.shape == () and torch.equal(invalid, want_invalid)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_merge_wrapper_on_the_cpu_runs_the_plain_version_and_launches_nothing(dtype):
    rng = np.random.RandomState(5)
    leaves, ids = _merge_leaves(rng, 40, 6, dtype), _merge_ids(rng, 40, 6, torch.int64)
    got = segment_merge_cuda(leaves, ids, 6, device="cpu")
    want = segment_merge_torch(leaves, ids, 6)
    assert all(torch.equal(g, w) or torch.equal(g.isnan(), w.isnan()) for g, w in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert _common.dispatch_count("segment_merge", "torch") == 1 and _common.launch_count("segment_merge") == 0
    for op in ("add", "max", "min"):
        assert _common.dispatch_count(f"segment_scatter_{op}", "torch") == 0


def test_merge_int32_sums_are_exact_past_2_24():
    """int32 sums add in int32: a segment's batch sum past 2^24 of odd values,
    where float32 would round, equals numpy's int64 sum."""
    rng = np.random.RandomState(7)
    x = (rng.randint(2**21, 2**22, 64) | 1).astype(np.int32)
    ids = rng.randint(0, 2, 64)
    state = torch.tensor([[3], [-9]], dtype=torch.int32)
    (out,), counts, _ = segment_merge_torch([(torch.from_numpy(x).reshape(64, 1), state,
                                              torch.zeros(1, dtype=torch.int32), "sum")], torch.from_numpy(ids), 2)
    want = np.array([[3 + x[ids == 0].astype(np.int64).sum()], [-9 + x[ids == 1].astype(np.int64).sum()]])
    assert want.max() > 2**24
    np.testing.assert_array_equal(out.numpy(), want)
    assert out.numpy().astype(np.float64).tolist() != want.astype(np.float32).astype(np.float64).tolist()


def test_merge_picks_against_the_state_in_xla_order():
    """An extremum picks against the state in XLA's order: +0.0 beats a -0.0
    state in a max, -0.0 a +0.0 state in a min, a NaN state stays NaN and a
    NaN row makes the segment NaN; an empty segment keeps even a -0.0 state."""
    state = torch.tensor([[-0.0], [0.0], [float("nan")], [1.0], [-0.0]])
    rows = torch.tensor([[0.0], [-0.0], [5.0], [float("nan")]])
    ids = torch.arange(4)
    zero = torch.zeros(1)
    (hi, lo), _, _ = segment_merge_torch([(rows, state, zero, "max"), (rows, state, zero, "min")], ids, 5)
    assert hi[0, 0] == 0 and not torch.signbit(hi[0, 0]) and hi[1, 0] == 0 and not torch.signbit(hi[1, 0])
    assert lo[0, 0] == 0 and torch.signbit(lo[0, 0]) and lo[1, 0] == 0 and torch.signbit(lo[1, 0])
    assert torch.isnan(hi[2:4]).all() and torch.isnan(lo[2:4]).all()
    assert hi[4, 0] == 0 and torch.signbit(hi[4, 0]) and lo[4, 0] == 0 and torch.signbit(lo[4, 0])


def test_merge_rows_are_read_in_place_at_their_row_stride():
    """A slice of B1's ``(R, 4, D)`` output and a broadcast default go to the
    kernel as they lie (their own pointer, stride 4 * D and 0); only rows whose
    elements are not adjacent are copied."""
    buf = torch.arange(8 * 4 * 10, dtype=torch.int32).reshape(8, 4, 10)
    view, stride = ss._row_view(buf[:, 1, :], 8, 10)
    assert view.data_ptr() == buf[:, 1, :].data_ptr() and stride == 40
    scalar = torch.tensor(3, dtype=torch.int32).expand(8)
    view, stride = ss._row_view(scalar, 8, 1)
    assert view.data_ptr() == scalar.data_ptr() and stride == 0
    wide = torch.zeros(10, dtype=torch.int32).expand(8, 10)
    view, stride = ss._row_view(wide, 8, 10)
    assert view.data_ptr() == wide.data_ptr() and stride == 0
    cube = torch.zeros(8, 2, 5)
    view, stride = ss._row_view(cube, 8, 10)
    assert view.data_ptr() == cube.data_ptr() and stride == 10 and view.shape == (8, 10)
    transposed = torch.arange(80.0).reshape(10, 8).t()
    view, stride = ss._row_view(transposed, 8, 10)
    assert view.is_contiguous() and stride == 10 and torch.equal(view, transposed)


_S = torch.zeros((3, 2), dtype=torch.int32)
_D = torch.zeros(2, dtype=torch.int32)
_R = torch.zeros((4, 2), dtype=torch.int32)
_IDS = torch.zeros(4, dtype=torch.int64)


@pytest.mark.parametrize(
    "leaves,ids,s,error",
    [
        ([(_R.double(), _S.double(), _D.double(), "sum")], _IDS, 3, TypeError),
        ([(_R.float(), _S, _D, "sum")], _IDS, 3, TypeError),
        ([(_R, _S, _D.float(), "max")], _IDS, 3, TypeError),
        ([(_R, _S, _D, "mean")], _IDS, 3, ValueError),
        ([(_R[:3], _S, _D, "sum")], _IDS, 3, ValueError),
        ([(_R, _S[:2], _D, "sum")], _IDS, 3, ValueError),
        ([(_R, _S, _D[:1], "sum")], _IDS, 3, ValueError),
        ([(_R[:, :1], _S, _D, "min")], _IDS, 3, ValueError),
        ([(_R, _S, _D, "sum")], _IDS.reshape(4, 1), 3, ValueError),
        ([(_R, _S, _D, "sum")], _IDS.float(), 3, TypeError),
        ([(_R, _S[:0], _D, "sum")], _IDS, 0, ValueError),
    ],
)
def test_merge_rejects_what_the_kernel_does_not_take(leaves, ids, s, error):
    with pytest.raises(error):
        segment_merge_cuda(leaves, ids, s, device="cpu")
    assert _common.dispatch_count("segment_merge", "torch") == 0


def test_merge_rejects_items_past_the_32_bit_index(monkeypatch):
    """R * (1 + the leaves' widths) must stay below 2**31 (lowered here)."""
    monkeypatch.setattr(ss, "_MAX_ITEMS", 4 * (1 + 2 + 2))
    leaf = (_R, _S, _D, "sum")
    with pytest.raises(ValueError, match="32 bits"):
        segment_merge_cuda([leaf, leaf], _IDS, 3, device="cpu")
    outs, counts, _ = segment_merge_cuda([leaf], _IDS, 3, device="cpu")
    assert len(outs) == 1 and int(counts.sum()) == 4


def _merge_case():
    """Four leaves as B's bundles give them: a broadcast int32 sum, a dense
    float32 sum of width 40, an int32 max, a float32 min sliced from an
    (R, 4, 10) buffer at 40 bytes (8-byte aligned)."""
    r, s = 8, 10
    buf = torch.ones(r, 4, 10)
    leaves = [
        (torch.tensor(1, dtype=torch.int32).expand(r), torch.ones(s, dtype=torch.int32),
         torch.tensor(0, dtype=torch.int32), "sum"),
        (torch.ones(r, 40), torch.ones(s, 40), torch.ones(40), "sum"),
        (torch.ones(r, dtype=torch.int32), torch.ones(s, dtype=torch.int32), torch.tensor(0, dtype=torch.int32),
         "max"),
        (buf[:, 1, :], torch.ones(s, 10), torch.ones(10), "min"),
    ]
    return leaves, torch.arange(r), s


@pytest.mark.parametrize("ids_dtype", [torch.int64, torch.int32])
def test_merge_cuda_path_makes_one_library_call_with_the_leaf_table(fake_library, ids_dtype):
    """One call into the C library with the leaves' table packed by value
    (rows, row stride, state, out, default, D, V, kind per leaf), the outputs
    allocated with ``torch.empty`` only, the device index and the stream."""
    leaves, ids, s = _merge_case()
    ids = ids.to(ids_dtype)
    outs, counts, invalid = ss._merge_cuda(leaves, ids, s, torch.device("cpu"))
    assert fake_library.entries == ["segment_merge_launch"] and len(fake_library.calls) == 1
    args = fake_library.calls[0]
    assert args[1] == 4 and args[2] == ids.data_ptr() and args[3:6] == (8, s, ids.element_size())
    assert args[6] == counts.data_ptr() and args[7] == invalid.data_ptr() and args[9] == 1234
    table = np.asarray(struct.unpack("<32q", args[0])).reshape(4, 8)
    strides, widths, vecs, kinds = (0, 40, 1, 40), (1, 40, 1, 10), (1, 4, 1, 2), (0, 1, 2, 5)
    for (rows, state, default, _), out, row, stride, d, vec, kind in zip(leaves, outs, table, strides, widths,
                                                                      vecs, kinds):
        assert row.tolist() == [rows.data_ptr(), stride, state.data_ptr(), out.data_ptr(), default.data_ptr(), d,
                                vec, kind]
        assert out.shape == state.shape and out.dtype == state.dtype and out.is_contiguous()
        assert out.data_ptr() != state.data_ptr()
    assert counts.shape == (s,) and counts.dtype == torch.int32
    assert invalid.shape == () and invalid.dtype == torch.int32
    assert _common.launch_count("segment_merge") == 1


def test_a_failed_merge_launch_raises_and_is_not_counted(fake_library):
    fake_library.err = 700
    leaves, ids, s = _merge_case()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ss._merge_cuda(leaves, ids, s, torch.device("cpu"))
    assert _common.launch_count("segment_merge") == 0
