"""The port's kernel modules (``metrics_tpu_torch/kernels``) against the JAX package's.

The plain PyTorch versions are held against both JAX formulations of each
kernel (``_xla`` and the Pallas kernel in interpret mode) on the same numpy
inputs, exactly. The wrappers are held to their device rule: a CPU tensor
runs the plain version and launches nothing. The shared plumbing caches its
answers: the capability of a device is asked once, and a resolved C entry is
read without the lock. The cases that launch the CUDA kernels need a card;
they carry the ``cuda`` marker and skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.kernels.confusion_matrix import confmat_counts_pallas, confmat_counts_xla
from metrics_tpu.kernels.stat_scores import stat_scores_counts_pallas, stat_scores_counts_xla
from metrics_tpu_torch.kernels import _common
from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_cuda, confmat_counts_torch
from metrics_tpu_torch.kernels.stat_scores import stat_scores_counts_cuda, stat_scores_counts_torch


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


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(1, 1), (1023, 129), (1024, 1000), (4096, 2048)])
def test_stat_scores_kernel_matches_plain(cuda_device, n, c):
    preds, target = (torch.from_numpy(x).to(cuda_device) for x in _binary(n, c, seed=c))
    got = stat_scores_counts_cuda(preds, target)
    torch.cuda.synchronize()
    for g, w in zip(got, stat_scores_counts_torch(preds, target)):
        assert torch.equal(g, w)
    assert _common.launch_count("stat_scores_counts") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,dtype", [(1, 1000, torch.int64), (1024, 3, torch.int64), (1024, 64, torch.int32),
                                       (1024, 1000, torch.int64)])
def test_confmat_kernel_matches_plain(cuda_device, n, c, dtype):
    preds, target = (torch.from_numpy(x).to(cuda_device, dtype) for x in _labels(n, c, seed=c))
    got = confmat_counts_cuda(preds, target, c)
    torch.cuda.synchronize()
    assert torch.equal(got, confmat_counts_torch(preds, target, c))
    assert _common.launch_count("confmat_counts") == 1


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    p = torch.zeros(8, 4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        stat_scores_counts_cuda(p, p)
    q = torch.zeros(4, 8, dtype=torch.int32, device=cuda_device).t()
    with pytest.raises(ValueError):
        stat_scores_counts_cuda(q, q)
    with pytest.raises(TypeError):
        confmat_counts_cuda(p[:, 0].contiguous(), p[:, 0].int().contiguous(), 3)
    assert _common.launch_count("stat_scores_counts") == 0
