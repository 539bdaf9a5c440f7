"""The port's audio metrics (SNR, SI-SNR, SI-SDR) against the JAX package's.

Mirrors ``tests/audio/test_audio.py`` case by case: the same seeded numpy
signals go through the ``metrics_tpu`` object and its ``metrics_tpu_torch``
counterpart (``device="cpu"``), ``forward`` per batch and ``compute`` at the
end, or two ranks simulated by threads
(``tests/test_torch_distributed.py::_run_ranks``) against the JAX package's
``sharded_compute``; the functionals per batch; gradients against
``jax.grad`` on float64 signals; bfloat16 inputs. Float32 values agree
within ``rtol=1e-5`` (``atol=1e-5`` dB for values near 0 dB): a value near
-60 dB is the log of a ratio of float32 sums that XLA and ATen add in
different orders, and sits up to 1.5e-6 relative apart. Beyond the
JAX tests: the input dtype's eps (float64 stays float64, float16 takes its
own eps of 9.8e-4), integer inputs raising ``ValueError`` in both packages,
and the keyed ``SI_SDR``/``SNR`` against the JAX package's keyed forms,
both states through the segment scatter B3's wrapper in one dispatch.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as JF
import metrics_tpu_torch as T
import metrics_tpu_torch.functional as TF
from metrics_tpu_torch.kernels import _common
from tests.helpers.testers import BATCH_SIZE, NUM_BATCHES, sharded_compute
from tests.test_torch_distributed import _run_ranks

CPU = {"device": "cpu"}
TOL = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)
TIME = 100

_rng = np.random.RandomState(42)
_preds = _rng.randn(NUM_BATCHES, BATCH_SIZE, TIME).astype(np.float32)
_target = _rng.randn(NUM_BATCHES, BATCH_SIZE, TIME).astype(np.float32)

_CASES = [
    pytest.param("SI_SDR", "si_sdr", {"zero_mean": False}, id="si_sdr"),
    pytest.param("SI_SDR", "si_sdr", {"zero_mean": True}, id="si_sdr_zero_mean"),
    pytest.param("SNR", "snr", {"zero_mean": False}, id="snr"),
    pytest.param("SNR", "snr", {"zero_mean": True}, id="snr_zero_mean"),
    pytest.param("SI_SNR", "si_snr", {}, id="si_snr"),
]


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float64), **(tol or TOL))


@pytest.mark.parametrize("name, fn, args", _CASES)
@pytest.mark.parametrize("ddp", [False, True])
def test_class(ddp, name, fn, args):
    jax_cls, port_cls = getattr(J, name), getattr(T, name)
    if not ddp:
        jm, tm = jax_cls(**args), port_cls(**args, **CPU)
        for i in range(NUM_BATCHES):
            _close(tm(_t(_preds[i]), _t(_target[i])), jm(jnp.asarray(_preds[i]), jnp.asarray(_target[i])))
        got, want = tm.compute(), jm.compute()
    else:
        ranks = [jax_cls(**args) for _ in range(2)]
        for i in range(NUM_BATCHES):
            ranks[i % 2].update(jnp.asarray(_preds[i]), jnp.asarray(_target[i]))
        want = sharded_compute(ranks[0], ranks)

        def rank(r):
            def run():
                m = port_cls(**args, **CPU)
                for i in range(r, NUM_BATCHES, 2):
                    m.update(_t(_preds[i]), _t(_target[i]))
                with m.sync_context(distributed_available=lambda: True):
                    return m.compute()

            return run

        results, errors, calls = _run_ranks([rank(0), rank(1)], "torch")
        assert errors == [None, None] and calls[0] == calls[1] > 0
        torch.testing.assert_close(results[0], results[1], rtol=0, atol=0)
        got = results[0]
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("name, fn, args", _CASES)
def test_functional(name, fn, args):
    for i in range(NUM_BATCHES):
        got = getattr(TF, fn)(_t(_preds[i]), _t(_target[i]), **args)
        assert got.dtype == torch.float32 and got.shape == (BATCH_SIZE,)
        _close(got, getattr(JF, fn)(jnp.asarray(_preds[i]), jnp.asarray(_target[i]), **args))


@pytest.mark.parametrize("name, fn, args", _CASES)
def test_gradient_matches_jax_grad(name, fn, args):
    x = torch.tensor(_preds[0], dtype=torch.float64, requires_grad=True)
    (grad,) = torch.autograd.grad(getattr(TF, fn)(x, _t(_target[0]).double(), **args).sum(), x)
    want = jax.grad(lambda p: jnp.sum(getattr(JF, fn)(p, jnp.asarray(_target[0], jnp.float64), **args)))(
        jnp.asarray(_preds[0], jnp.float64))
    assert grad.dtype == torch.float64 and getattr(T, name).is_differentiable
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), **F64)


@pytest.mark.parametrize("name, fn, args", _CASES)
def test_bf16(name, fn, args):
    got = getattr(TF, fn)(_t(_preds[0]).to(torch.bfloat16), _t(_target[0]), **args)
    want = getattr(JF, fn)(jnp.asarray(_preds[0], jnp.bfloat16), jnp.asarray(_target[0]), **args)
    assert got.dtype == torch.float32 == torch.promote_types(torch.bfloat16, torch.float32)
    assert bool(torch.isfinite(got).all()) and bool(jnp.all(jnp.isfinite(want.astype(jnp.float32))))
    # both use bfloat16's eps (7.8e-3); the products round in float32 alike
    _close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float64", "float16"])
@pytest.mark.parametrize("name, fn, args", _CASES)
def test_input_dtype_sets_eps_and_result_dtype(dtype, name, fn, args):
    p, t = _preds[0][:4].astype(dtype), _target[0][:4].astype(dtype)
    got = getattr(TF, fn)(_t(p), _t(t), **args)
    want = getattr(JF, fn)(jnp.asarray(p), jnp.asarray(t), **args)
    assert str(got.dtype) == f"torch.{dtype}" and str(want.dtype) == dtype
    # float16: both packages add eps 9.8e-4 in float16 and sum in float16
    _close(got, want, **(F64 if dtype == "float64" else dict(rtol=2e-3, atol=2e-2)))


@pytest.mark.parametrize("name, fn, args", _CASES)
def test_integer_inputs_raise_as_in_the_jax_package(name, fn, args):
    ints = np.arange(8).reshape(2, 4)
    with pytest.raises(ValueError, match="not inexact"):
        getattr(JF, fn)(jnp.asarray(ints), jnp.asarray(ints), **args)
    with pytest.raises(ValueError, match="not inexact"):
        getattr(TF, fn)(_t(ints), _t(ints), **args)


def test_si_sdr_known_value():
    target = torch.tensor([3.0, -0.5, 2.0, 7.0])
    preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
    np.testing.assert_allclose(TF.si_sdr(preds, target).numpy(), 18.4030, atol=1e-3)
    np.testing.assert_allclose(TF.si_snr(preds, target).numpy(), 15.0918, atol=1e-3)
    np.testing.assert_allclose(TF.snr(preds, target).numpy(), 16.1805, atol=1e-3)


@pytest.mark.parametrize("fn", ["si_sdr", "snr", "si_snr"])
def test_audio_shape_mismatch_raises(fn):
    with pytest.raises(RuntimeError):
        getattr(TF, fn)(torch.zeros((4, 10)), torch.zeros((4, 11)))


def test_states_are_a_float32_sum_and_an_int32_count():
    for m in (T.SI_SDR(**CPU), T.SI_SNR(**CPU), T.SNR(**CPU)):
        assert set(m._reductions.values()) == {"sum"}
        dtypes = sorted(str(v.dtype) for v in m._defaults.values())
        assert dtypes == ["torch.float32", "torch.int32"]
        m.update(_t(_preds[0]).double(), _t(_target[0]).double())
        assert sorted(str(v.dtype) for v in m._get_states().values()) == dtypes
        assert int(m.total) == BATCH_SIZE


# -- keyed --------------------------------------------------------------------------------


def _keyed_batches(seed, n_tenants, batches=4, rows=24):
    rng = np.random.RandomState(seed)
    return [(rng.randint(-1, n_tenants, rows), rng.randn(rows, TIME).astype(np.float32),
             rng.randn(rows, TIME).astype(np.float32)) for _ in range(batches)]


@pytest.mark.parametrize("name, fn, args", [c for c in _CASES if c.values[0] != "SI_SNR"])
def test_keyed_matches_the_jax_keyed_form_through_one_b3_dispatch(name, fn, args):
    n = 7
    jk = getattr(J, name)(**args).keyed(n, validate_ids=False)
    tk = getattr(T, name)(**args, **CPU).keyed(n, validate_ids=False)
    _common.reset_dispatch_counters()
    batches = _keyed_batches(5, n)
    for ids, p, t in batches:
        jk.update(jnp.asarray(ids), jnp.asarray(p), jnp.asarray(t))
        tk.update(_t(ids), _t(p), _t(t))
    # both leaves (float32 sum, int32 count) ride one merge dispatch per update
    assert _common.dispatch_summary()["dispatch"] == {"segment_merge": {"torch": len(batches)}}
    assert tk.total.dtype == torch.int32
    np.testing.assert_array_equal(tk.total.numpy(), np.asarray(jk.total))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = tk.compute(), jk.compute()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5, equal_nan=True)


def test_multitenant_collection_of_si_sdr_and_snr_matches_the_jax_package():
    n = 9
    jc = J.MultiTenantCollection([J.SI_SDR(), J.SNR()], n, validate_ids=False)
    tc = T.MultiTenantCollection([T.SI_SDR(**CPU), T.SNR(**CPU)], n, validate_ids=False, **CPU)
    _common.reset_dispatch_counters()
    batches = _keyed_batches(6, n)
    for ids, p, t in batches:
        jc.update(jnp.asarray(ids), jnp.asarray(p), jnp.asarray(t))
        tc.update(_t(ids), _t(p), _t(t))
    assert tc.state_bundles == 2
    # one merge an update over both bundles' leaves
    assert _common.dispatch_summary()["dispatch"] == {"segment_merge": {"torch": len(batches)}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = tc.compute(), jc.compute()
    assert sorted(got) == sorted(want) == ["SI_SDR", "SNR"]
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5, equal_nan=True)


def test_audio_names_are_exported_as_the_jax_package_exports_them():
    for name in ("SI_SDR", "SI_SNR", "SNR"):
        assert hasattr(J, name) and hasattr(T, name)
    for name in ("si_sdr", "si_snr", "snr"):
        assert hasattr(JF, name) and hasattr(TF, name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.SI_SDR()
