"""The port's kernel modules (``metrics_tpu_torch/kernels``) against the JAX package's.

The plain PyTorch versions are held against both JAX formulations of each
kernel (``_xla`` and the Pallas kernel in interpret mode) on the same numpy
inputs, exactly. The wrappers are held to their device rule: a CPU tensor
runs the plain version and launches nothing. The shared plumbing caches its
answers: the capability of a device is asked once, and a resolved C entry is
read without the lock, a resolved device is taken as it is. The CUDA path's
plumbing of B1 and B2 (one call into the C library with the device index
and the stream handle, no ``torch.cuda.device`` context) is held against a
fake library, as are the batched entries of B1 (a bootstrap's stack and the
keyed rows' ``(R, 1, C)`` stack) and B2 (one call, no index ops, the
output its only allocation) and the vmap rules of B1 and B2 (one dispatch
for a whole ``torch.func.vmap`` stack). The cases that launch the CUDA
kernels need a card: they live in ``tests/test_torch_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.kernels.confusion_matrix import confmat_counts_pallas, confmat_counts_xla
from metrics_tpu.kernels.stat_scores import stat_scores_counts_pallas, stat_scores_counts_xla
from metrics_tpu_torch.kernels import _common
from metrics_tpu_torch.kernels import confusion_matrix as cm
from metrics_tpu_torch.kernels import stat_scores as st
from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_cuda, confmat_counts_torch
from metrics_tpu_torch.kernels.stat_scores import stat_scores_counts_cuda, stat_scores_counts_torch


@pytest.fixture(autouse=True)
def _zero_counters():
    _common.reset_dispatch_counters()
    yield
    _common.reset_dispatch_counters()


def _binary(n, c, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2, (n, c)).astype(np.int32), rng.randint(0, 2, (n, c)).astype(np.int32)


def _labels(n, c, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, c, n).astype(np.int64), rng.randint(0, c, n).astype(np.int64)


@pytest.mark.parametrize("n,c", [(1, 1), (37, 1), (256, 5), (255, 129), (100, 600)])
def test_stat_scores_plain_matches_jax(n, c):
    preds, target = _binary(n, c, seed=n * 1000 + c)
    want_xla = stat_scores_counts_xla(jnp.asarray(preds), jnp.asarray(target))
    want_pallas = stat_scores_counts_pallas(jnp.asarray(preds), jnp.asarray(target), interpret=True)
    got = stat_scores_counts_torch(torch.from_numpy(preds), torch.from_numpy(target))
    for g, x, p in zip(got, want_xla, want_pallas):
        assert g.dtype == torch.int32 and g.shape == (c,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))


@pytest.mark.parametrize("b,n,c", [(1, 1, 1), (3, 37, 5), (20, 64, 129)])
def test_stat_scores_plain_batched_matches_jax_vmapped(b, n, c):
    """The plain version of a ``(B, N, C)`` stack against the JAX package's
    Pallas kernel under ``jax.vmap`` (``pallas_call``'s batching rule, in
    interpret mode) and its ``_xla`` formulation slice by slice."""
    import jax

    preds, target = _binary(b * n, c, seed=b * 100 + c)
    preds, target = preds.reshape(b, n, c), target.reshape(b, n, c)
    want_pallas = jax.vmap(lambda p, t: stat_scores_counts_pallas(p, t, interpret=True))(
        jnp.asarray(preds), jnp.asarray(target))
    got = stat_scores_counts_torch(torch.from_numpy(preds), torch.from_numpy(target))
    for k, (g, p) in enumerate(zip(got, want_pallas)):
        assert g.dtype == torch.int32 and g.shape == (b, c)
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
        for i in range(b):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(stat_scores_counts_xla(preds[i], target[i])[k]))


@pytest.mark.parametrize("target_batched", [True, False])
def test_stacked_counts_under_vmap_dispatch_once_for_the_whole_stack(target_batched):
    """Inside ``torch.func.vmap`` the vmap rule hands the whole stack to the
    wrapper in one dispatch (one launch on the card); a nested vmap's batch
    axes flatten into the same one."""
    preds, target = _binary(24 * 9, 7, seed=5)
    p = torch.from_numpy(preds).reshape(2, 3, 36, 7)
    t = torch.from_numpy(target).reshape(2, 3, 36, 7)
    if not target_batched:
        t = t[0, 0]
    dims = 0 if target_batched else None
    got = torch.func.vmap(st.stat_scores_counts_stacked, in_dims=(0, dims))(p[0], t[0] if target_batched else t)
    assert _common.dispatch_count("stat_scores_counts", "torch") == 1
    for i in range(3):
        want = stat_scores_counts_torch(p[0, i], t[0, i] if target_batched else t)
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    nested = torch.func.vmap(torch.func.vmap(st.stat_scores_counts_stacked, in_dims=(0, dims)),
                             in_dims=(0, dims))(p, t)
    assert _common.dispatch_count("stat_scores_counts", "torch") == 2
    for g, w in zip(nested, stat_scores_counts_torch(p, t if target_batched else t.expand(2, 3, 36, 7))):
        assert g.shape == (2, 3, 7) and torch.equal(g, w)
    assert _common.launch_count("stat_scores_counts") == 0


@pytest.mark.parametrize("n,c", [(1, 1), (37, 3), (256, 129), (200, 600)])
def test_confmat_plain_matches_jax(n, c):
    preds, target = _labels(n, c, seed=n * 1000 + c)
    want_xla = confmat_counts_xla(jnp.asarray(preds), jnp.asarray(target), c)
    want_pallas = confmat_counts_pallas(jnp.asarray(preds), jnp.asarray(target), c, interpret=True)
    got = confmat_counts_torch(torch.from_numpy(preds), torch.from_numpy(target), c)
    assert got.dtype == torch.int32 and got.shape == (c, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    assert int(got.sum()) == n


@pytest.mark.parametrize("b,n,c", [(1, 1, 1), (3, 37, 5), (8, 1, 16), (4, 50, 129)])
def test_confmat_plain_batched_matches_jax_vmapped(b, n, c):
    """The plain version of a ``(B, N)`` stack against the JAX package's
    Pallas kernel under ``jax.vmap`` (``pallas_call``'s batching rule, in
    interpret mode) and its ``_xla`` formulation row by row."""
    import jax

    preds, target = (x.reshape(b, n) for x in _labels(b * n, c, seed=b * 100 + c))
    want_pallas = jax.vmap(lambda p, t: confmat_counts_pallas(p, t, c, interpret=True))(
        jnp.asarray(preds), jnp.asarray(target))
    got = cm.confmat_counts_batched_torch(torch.from_numpy(preds), torch.from_numpy(target), c)
    assert got.dtype == torch.int32 and got.shape == (b, c, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    for i in range(b):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(confmat_counts_xla(preds[i], target[i], c)))


@pytest.mark.parametrize("target_batched", [True, False])
def test_stacked_confmat_under_vmap_dispatch_once_for_the_whole_stack(target_batched):
    """Inside ``torch.func.vmap`` B2's vmap rule hands the whole stack to the
    batched wrapper in one dispatch (one launch on the card); a nested
    vmap's batch axes flatten into the same one."""
    preds, target = _labels(2 * 3 * 40, 6, seed=11)
    p = torch.from_numpy(preds).reshape(2, 3, 40)
    t = torch.from_numpy(target).reshape(2, 3, 40)
    if not target_batched:
        t = t[0, 0]
    dims = 0 if target_batched else None
    got = torch.func.vmap(cm.confmat_counts_stacked, in_dims=(0, dims, None))(
        p[0], t[0] if target_batched else t, 6)
    assert _common.dispatch_count("confmat_counts", "torch") == 1
    for i in range(3):
        assert torch.equal(got[i], confmat_counts_torch(p[0, i], t[0, i] if target_batched else t, 6))
    nested = torch.func.vmap(torch.func.vmap(cm.confmat_counts_stacked, in_dims=(0, dims, None)),
                             in_dims=(0, dims, None))(p, t, 6)
    assert _common.dispatch_count("confmat_counts", "torch") == 2
    assert nested.shape == (2, 3, 6, 6)
    for i in range(2):
        for j in range(3):
            assert torch.equal(nested[i, j], confmat_counts_torch(p[i, j], t[i, j] if target_batched else t, 6))
    assert _common.launch_count("confmat_counts") == 0


def test_confmat_out_of_range_pairs_are_dropped():
    """The JAX formulations disagree here: ``_pallas`` drops the pairs whose
    label lies outside [0, C), ``_xla`` wraps the flat index. The port drops."""
    preds = np.asarray([0, 3, -1, 1])
    target = np.asarray([0, 0, 0, 2])
    pallas = np.asarray(confmat_counts_pallas(jnp.asarray(preds), jnp.asarray(target), 3, interpret=True))
    xla = np.asarray(confmat_counts_xla(jnp.asarray(preds), jnp.asarray(target), 3))
    got = confmat_counts_torch(torch.from_numpy(preds), torch.from_numpy(target), 3)
    wrapped = confmat_counts_cuda(torch.from_numpy(preds), torch.from_numpy(target), 3, device="cpu")
    expected = np.zeros((3, 3), np.int32)
    expected[0, 0] = 1
    expected[2, 1] = 1
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(wrapped.numpy(), expected)
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert not np.array_equal(got.numpy(), xla)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    preds, target = _binary(64, 5, seed=1)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    for got, want in zip(stat_scores_counts_cuda(p, t, device="cpu"), stat_scores_counts_torch(p, t)):
        assert torch.equal(got, want)
    lp, lt = (torch.from_numpy(x) for x in _labels(64, 5, seed=2))
    assert torch.equal(confmat_counts_cuda(lp, lt, 5, device="cpu"), confmat_counts_torch(lp, lt, 5))
    for op in ("stat_scores_counts", "confmat_counts"):
        assert _common.launch_count(op) == 0
        assert _common.dispatch_count(op, "torch") == 1


def test_cpu_tensors_raise_under_the_default_cuda_device():
    preds, target = (torch.from_numpy(x) for x in _binary(8, 3, seed=3))
    with pytest.raises((RuntimeError, ValueError)):
        stat_scores_counts_cuda(preds, target)
    with pytest.raises((RuntimeError, ValueError)):
        confmat_counts_cuda(preds[:, 0], target[:, 0], 3)
    assert _common.launch_count("stat_scores_counts") == 0


@pytest.mark.parametrize(
    "call",
    [
        lambda: stat_scores_counts_cuda(torch.zeros(4, 3, dtype=torch.int32), torch.zeros(4, 2, dtype=torch.int32),
                                        device="cpu"),
        lambda: stat_scores_counts_cuda(torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
                                        device="cpu"),
        lambda: confmat_counts_cuda(torch.zeros(4, dtype=torch.int64), torch.zeros(3, dtype=torch.int64), 2,
                                    device="cpu"),
        lambda: confmat_counts_cuda(torch.zeros(4, 1, dtype=torch.int64), torch.zeros(4, 1, dtype=torch.int64), 2,
                                    device="cpu"),
        lambda: confmat_counts_cuda(torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64), 0,
                                    device="cpu"),
        lambda: confmat_counts_cuda(torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64), 46341,
                                    device="cpu"),
    ],
)
def test_wrappers_reject_shapes_the_kernel_does_not_take(call):
    with pytest.raises(ValueError):
        call()


def _recording_capability(monkeypatch, capability):
    asked = []
    monkeypatch.setattr(_common, "_CAPABLE_DEVICES", set())
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device: asked.append(device) or capability)
    return asked


def test_require_capability_asks_each_device_once(monkeypatch):
    asked = _recording_capability(monkeypatch, (9, 0))
    for _ in range(3):
        _common.require_capability(torch.device("cuda", 0))
    assert len(asked) == 1
    _common.require_capability(torch.device("cuda", 1))
    _common.require_capability(torch.device("cuda", 1))
    assert len(asked) == 2


def test_require_capability_raises_on_every_call_for_another_card(monkeypatch):
    asked = _recording_capability(monkeypatch, (8, 0))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="sm_90a"):
            _common.require_capability(torch.device("cuda", 0))
    assert len(asked) == 2


def test_kernel_function_reads_a_resolved_entry_without_the_lock(monkeypatch):
    class NoLock:
        def __enter__(self):
            raise AssertionError("the lock was taken on a resolved entry")

        def __exit__(self, *exc):
            return False

    entry = object()
    monkeypatch.setitem(_common._FUNCTIONS, "probe_entry", entry)
    monkeypatch.setattr(_common, "_LIB_LOCK", NoLock())
    assert _common.kernel_function("probe_entry", ()) is entry


def test_kernel_device_takes_a_resolved_device_as_it_is(monkeypatch):
    """A ``torch.device`` that names its index skips ``resolve_device``
    (whose CUDA query would raise here); a string or a bare ``cuda`` goes
    through it."""
    resolved = torch.device("cuda", 1)
    assert _common.kernel_device(resolved) is resolved
    assert _common.kernel_device("cpu") == torch.device("cpu")
    seen = []
    monkeypatch.setattr(_common, "resolve_device", lambda device: seen.append(device) or torch.device("cuda", 0))
    assert _common.kernel_device("cuda") == torch.device("cuda", 0)
    assert _common.kernel_device(torch.device("cuda")) == torch.device("cuda", 0)
    assert seen == ["cuda", torch.device("cuda")]


def test_sm_count_asks_each_device_once(monkeypatch):
    calls = []

    class _Properties:
        multi_processor_count = 132

    monkeypatch.setattr(_common, "_SM_COUNTS", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: calls.append(device) or _Properties())
    device = torch.device("cuda", 3)
    assert [_common.sm_count(device) for _ in range(3)] == [132, 132, 132]
    assert calls == [device]


class _FakeLibrary:
    """Stands in for a C entry: records each call and returns ``err``."""

    def __init__(self):
        self.err, self.calls, self.entries = 0, [], []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


def _forbid(*_, **__):
    raise AssertionError("the CUDA path must not call this")


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()
    for module in (st, cm):
        monkeypatch.setattr(module, "kernel_function", lambda name, argtypes: lib.entries.append(name) or lib)
        monkeypatch.setattr(module, "current_stream_handle", lambda device: 1234)
    monkeypatch.setattr(torch.cuda, "device", _forbid)
    return lib


@pytest.mark.parametrize("n,c", [(8, 5), (1, 1), (300, 129)])
def test_stat_scores_cuda_path_makes_one_library_call_with_the_device_index(fake_library, n, c):
    """The C entry makes the device current itself: the wrapper enters no
    ``torch.cuda.device`` context and passes the device index and the
    stream handle."""
    preds, target = (torch.from_numpy(a) for a in _binary(n, c, seed=n + c))
    out = st._counts_cuda(preds, target, torch.device("cpu"))
    assert fake_library.entries == ["stat_scores_counts_launch"] and len(fake_library.calls) == 1
    args = fake_library.calls[0]
    assert len(args) == len(st._ARGTYPES)
    assert args[:4] == (preds.data_ptr(), target.data_ptr(), n, c) and args[5:] == (None, 1234)
    assert len(out) == 4 and all(o.shape == (c,) and o.dtype == torch.int32 for o in out)
    assert args[4] == out[0].data_ptr()
    assert _common.launch_count("stat_scores_counts") == 1


def test_stat_scores_batched_cuda_path_makes_one_library_call(fake_library):
    """A ``(B, N, C)`` stack goes to the batched C entry in one call, with
    its ``(4, B, C)`` output."""
    preds, target = (torch.from_numpy(a).reshape(4, 30, 9) for a in _binary(120, 9, seed=8))
    out = st._batched_counts_cuda(preds, target, torch.device("cpu"))
    assert fake_library.entries == ["stat_scores_counts_batched_launch"] and len(fake_library.calls) == 1
    args = fake_library.calls[0]
    assert len(args) == len(st._BATCHED_ARGTYPES)
    assert args[:5] == (preds.data_ptr(), target.data_ptr(), 4, 30, 9) and args[6:] == (None, 1234)
    assert len(out) == 4 and all(o.shape == (4, 9) and o.dtype == torch.int32 for o in out)
    assert args[5] == out[0].data_ptr()
    assert _common.launch_count("stat_scores_counts") == 1


def test_stat_scores_batched_cuda_path_gives_the_keyed_rows_one_call(fake_library):
    """The keyed path's ``(R, 1, C)`` stack of length-1 rows is one call into
    the batched C entry, which picks its short-slice layout itself."""
    preds, target = (torch.from_numpy(a).reshape(4096, 1, 10) for a in _binary(4096, 10, seed=9))
    out = st._batched_counts_cuda(preds, target, torch.device("cpu"))
    assert fake_library.entries == ["stat_scores_counts_batched_launch"] and len(fake_library.calls) == 1
    args = fake_library.calls[0]
    assert args[:5] == (preds.data_ptr(), target.data_ptr(), 4096, 1, 10) and args[6:] == (None, 1234)
    assert len(out) == 4 and all(o.shape == (4096, 10) and o.dtype == torch.int32 for o in out)
    assert args[5] == out[0].data_ptr()
    assert _common.launch_count("stat_scores_counts") == 1


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_confmat_batched_cuda_path_makes_one_library_call(fake_library, monkeypatch, dtype):
    """B2's batched form is one call into its own C entry with the stack's
    pointers, B, N, C, the index width and the output pointer; the output
    (allocated without a fill) is its only allocation, and no index op runs
    on the pairs."""
    preds, target = (torch.from_numpy(x).to(dtype).reshape(8192, 1) for x in _labels(8192, 16, seed=13))
    allocated = []
    real_empty = torch.empty
    with monkeypatch.context() as mp:
        mp.setattr(torch, "empty", lambda *a, **k: allocated.append(a) or real_empty(*a, **k))
        for name in ("zeros", "where", "arange", "cat", "bincount"):
            mp.setattr(torch, name, _forbid)
        mp.setattr(torch.Tensor, "long", _forbid)
        out = cm._batched_counts_cuda(preds, target, 16, torch.device("cpu"))
    assert fake_library.entries == ["confmat_counts_batched_launch"] and len(fake_library.calls) == 1
    args = fake_library.calls[0]
    assert len(args) == len(cm._BATCHED_ARGTYPES)
    assert args == (preds.data_ptr(), target.data_ptr(), 8192, 1, 16, preds.element_size(), out.data_ptr(), None,
                    1234)
    assert allocated == [((8192, 16, 16),)] and out.shape == (8192, 16, 16) and out.dtype == torch.int32
    assert _common.launch_count("confmat_counts") == 1


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_confmat_cuda_path_makes_one_library_call_with_the_device_index(fake_library, dtype):
    preds, target = (torch.from_numpy(a).to(dtype) for a in _labels(50, 7, seed=3))
    out = cm._counts_cuda(preds, target, 7, torch.device("cpu"))
    assert fake_library.entries == ["confmat_counts_launch"] and len(fake_library.calls) == 1
    args = fake_library.calls[0]
    assert len(args) == len(cm._ARGTYPES)
    assert args == (preds.data_ptr(), target.data_ptr(), 50, 7, preds.element_size(), out.data_ptr(), None, 1234)
    assert out.shape == (7, 7) and out.dtype == torch.int32
    assert _common.launch_count("confmat_counts") == 1


@pytest.mark.parametrize("op", ["stat_scores_counts", "confmat_counts"])
def test_a_failed_launch_raises_and_is_not_counted(fake_library, op):
    fake_library.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        if op == "stat_scores_counts":
            st._counts_cuda(torch.ones(4, 3, dtype=torch.int32), torch.ones(4, 3, dtype=torch.int32),
                            torch.device("cpu"))
        else:
            cm._counts_cuda(torch.ones(4, dtype=torch.int64), torch.ones(4, dtype=torch.int64), 3,
                            torch.device("cpu"))
    assert _common.launch_count(op) == 0 and _common.dispatch_count(op, "torch") == 0


def _stack_fn(x, y):
    """A stand-in for a batched wrapper: called on plain stacks only."""
    assert not torch._C._functorch.is_batchedtensor(x) and not torch._C._functorch.is_batchedtensor(y)
    return x * 2 + y.unsqueeze(-2), x.sum(-1)


def test_vmap_stack_takes_every_vmap_level_off_in_one_call():
    """The vmap rule leans on ``torch._C._functorch``'s interpreter stack;
    this holds its contract (so a torch release that changes those internals
    fails here): three nested vmaps, the middle one batching neither
    tensor, end in one call of ``fn`` on the flattened stack, with an
    unbatched tensor broadcast, and the outputs batched again level by level."""
    from torch._C import _functorch

    calls = []

    def fn(x, y):
        calls.append((tuple(x.shape), tuple(y.shape)))
        return _stack_fn(x, y)

    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    y = torch.arange(5, dtype=torch.float32) * 10
    zs = torch.zeros(7)
    a, b = torch.func.vmap(lambda xa: torch.func.vmap(lambda z: torch.func.vmap(
        lambda xc: _common.vmap_stack(fn, (xc, y)))(xa))(zs))(x)
    assert calls == [((6, 4, 5), (6, 5))]
    want_a, want_b = _stack_fn(x, y.expand(2, 3, 5))
    assert a.shape == (2, 7, 3, 4, 5) and b.shape == (2, 7, 3, 4)
    for k in range(7):
        assert torch.equal(a[:, k], want_a) and torch.equal(b[:, k], want_b)
    assert _functorch.get_dynamic_layer_stack_depth() == 0


def test_vmap_stack_refuses_a_transform_other_than_vmap_on_top():
    """A grad level above the batched tensor is refused, not mistaken for a
    vmap level; the layer stack is left whole by the refusal and by an
    error raised inside ``fn``."""
    from torch._C import _functorch

    ys = torch.ones(3, 5)

    def under_grad(y):
        return torch.func.grad(lambda w: _common.vmap_stack(_stack_fn, (y, w))[1].sum())(torch.ones(5))

    with pytest.raises(RuntimeError, match="innermost transform is TransformType.Grad"):
        torch.func.vmap(under_grad)(ys)
    assert _functorch.get_dynamic_layer_stack_depth() == 0

    def fails(x, y):
        raise ValueError("inside fn")

    with pytest.raises(ValueError, match="inside fn"):
        torch.func.vmap(torch.func.vmap(lambda x: _common.vmap_stack(fails, (x, x))))(torch.ones(2, 3, 4))
    assert _functorch.get_dynamic_layer_stack_depth() == 0
    got = torch.func.vmap(lambda x: _common.vmap_stack(_stack_fn, (x, x[0])))(torch.ones(2, 3, 4))
    assert got[0].shape == (2, 3, 4)
