"""The port's PSNR and SSIM against the JAX package's.

Mirrors the PSNR/SSIM cases of ``tests/image/test_psnr_ssim.py`` (the image
gradients wait for their module): the same seeded numpy images go through
the ``metrics_tpu`` object and its ``metrics_tpu_torch`` counterpart
(``device="cpu"``), ``forward`` per batch and ``compute`` at the end, or
two ranks simulated by threads (``tests/test_torch_distributed.py::_run_ranks``)
against the JAX package's ``sharded_compute``. The port smooths with two
depthwise convolutions; the JAX package with band-matrix matmuls up to 1024
pixels a side and with depthwise convolutions above: the port is held
against both forms. Float32 PSNR values agree within ``rtol=atol=1e-6``.
SSIM is held twice: on float64 images within ``rtol=atol=1e-12`` (the same
formula), and on float32 images within ``atol=1e-5``: the variance
cancellation ``E[X^2] - mu^2`` amplifies float32 rounding of the window
sums, and each package's float32 SSIM sits 0.3-4e-6 from the float64 value
(per pixel and averaged), the JAX package's two forms as far from each other.
Dtypes are asserted apart from the values.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as JF
import metrics_tpu.functional.regression.ssim as jax_ssim_module
import metrics_tpu_torch as T
import metrics_tpu_torch.functional as TF
import metrics_tpu_torch.regression as TR
from metrics_tpu_torch.functional.regression.ssim import _reflect_index
from tests.helpers.testers import NUM_BATCHES, sharded_compute
from tests.test_torch_distributed import _run_ranks

CPU = {"device": "cpu"}
TOL = dict(rtol=1e-6, atol=1e-6)
F64 = dict(rtol=1e-12, atol=1e-12)
SSIM_F32 = dict(rtol=0, atol=1e-5)

BATCH = 8
H = W = 24

_rng = np.random.RandomState(7)
_psnr_preds = _rng.rand(NUM_BATCHES, BATCH, 8, 8).astype(np.float32) * 3
_psnr_target = _rng.rand(NUM_BATCHES, BATCH, 8, 8).astype(np.float32) * 3
_ssim_preds = _rng.rand(NUM_BATCHES, BATCH, 3, H, W).astype(np.float32)
_ssim_target = (_ssim_preds * 0.8 + 0.1 * _rng.rand(NUM_BATCHES, BATCH, 3, H, W)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64), **(tol or TOL))


def _synced_compute(m):
    with m.sync_context(distributed_available=lambda: True):
        return m.compute()


def _run_class(jax_cls, port_cls, preds, target, args, ddp, result_dtype=torch.float32, tol=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if not ddp:
            jm, tm = jax_cls(**args), port_cls(**args, **CPU)
            for i in range(NUM_BATCHES):
                got = tm(_t(preds[i]), _t(target[i]))
                _close(got, jm(jnp.asarray(preds[i]), jnp.asarray(target[i])), **(tol or TOL))
            got, want = tm.compute(), jm.compute()
        else:
            ranks = [jax_cls(**args) for _ in range(2)]
            for i in range(NUM_BATCHES):
                ranks[i % 2].update(jnp.asarray(preds[i]), jnp.asarray(target[i]))
            want = sharded_compute(ranks[0], ranks)

            def rank(r):
                def run():
                    m = port_cls(**args, **CPU)
                    for i in range(r, NUM_BATCHES, 2):
                        m.update(_t(preds[i]), _t(target[i]))
                    return _synced_compute(m)

                return run

            results, errors, calls = _run_ranks([rank(0), rank(1)], "torch")
            assert errors == [None, None] and calls[0] == calls[1] > 0
            torch.testing.assert_close(results[0], results[1], rtol=0, atol=0)
            got = results[0]
    assert got.dtype == result_dtype
    _close(got, want, **(tol or TOL))


# -- PSNR -----------------------------------------------------------------------------

_PSNR_CASES = [
    pytest.param({}, id="running_range"),
    pytest.param({"data_range": 3.0}, id="data_range"),
    pytest.param({"base": 2.0}, id="base2"),
    pytest.param({"data_range": 3.0, "dim": (1, 2), "reduction": "elementwise_mean"}, id="dim_mean"),
    pytest.param({"data_range": 3.0, "dim": (1, 2), "reduction": "sum"}, id="dim_sum"),
]


@pytest.mark.parametrize("metric_args", _PSNR_CASES)
@pytest.mark.parametrize("ddp", [False, True])
def test_psnr_class(ddp, metric_args):
    _run_class(J.PSNR, T.PSNR, _psnr_preds, _psnr_target, metric_args, ddp)


@pytest.mark.parametrize("metric_args", _PSNR_CASES)
def test_psnr_functional(metric_args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(NUM_BATCHES):
            got = TF.psnr(_t(_psnr_preds[i]), _t(_psnr_target[i]), **metric_args)
            assert got.dtype == torch.float32
            _close(got, JF.psnr(jnp.asarray(_psnr_preds[i]), jnp.asarray(_psnr_target[i]), **metric_args))


def test_psnr_states_and_dtypes():
    running = T.PSNR(**CPU)
    assert running._reductions == {"sum_squared_error": "sum", "total": "sum", "min_target": "min",
                                   "max_target": "max"}
    assert running._defaults["total"].dtype == torch.int64
    assert all(running._defaults[n].dtype == torch.float32 for n in ("sum_squared_error", "min_target", "max_target"))
    running.update(_t(_psnr_preds[0]).double(), _t(_psnr_target[0]).double())
    assert running.sum_squared_error.dtype == torch.float32 and running.min_target.dtype == torch.float32
    with_dim = T.PSNR(data_range=3.0, dim=(1, 2), **CPU)
    assert isinstance(with_dim._defaults["sum_squared_error"], list) and with_dim._reductions["data_range"] == "mean"
    with_dim.update(_t(_psnr_preds[0]), _t(_psnr_target[0]))
    assert with_dim.total[0].shape == (BATCH,) and int(with_dim.total[0][0]) == 64


def test_psnr_dim_requires_data_range():
    with pytest.raises(ValueError) as port_err:
        T.PSNR(dim=0, **CPU)
    with pytest.raises(ValueError) as jax_err:
        J.PSNR(dim=0)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="data_range"):
        TF.psnr(torch.zeros((2, 2)), torch.zeros((2, 2)), dim=0)


def test_psnr_empty_dim_reduces_over_no_axis():
    p, t = _psnr_preds[0], _psnr_target[0]
    got = TF.psnr(_t(p), _t(t), data_range=3.0, dim=(), reduction="none")
    want = JF.psnr(jnp.asarray(p), jnp.asarray(t), data_range=3.0, dim=(), reduction="none")
    assert tuple(got.shape) == want.shape == p.shape
    _close(got, want)


# -- SSIM -----------------------------------------------------------------------------

_SSIM_CASES = [
    pytest.param({}, id="auto_range"),
    pytest.param({"data_range": 1.0}, id="data_range"),
    pytest.param({"kernel_size": (7, 7), "sigma": (1.0, 1.0)}, id="kernel7"),
    pytest.param({"k1": 0.02, "k2": 0.05}, id="k1k2"),
]


_SSIM_DTYPES = [
    pytest.param(np.float32, torch.float32, SSIM_F32, id="float32"),
    pytest.param(np.float64, torch.float64, F64, id="float64"),
]


@pytest.mark.parametrize("dtype, result_dtype, tol", _SSIM_DTYPES)
@pytest.mark.parametrize("metric_args", _SSIM_CASES)
@pytest.mark.parametrize("ddp", [False, True])
def test_ssim_class(ddp, metric_args, dtype, result_dtype, tol):
    _run_class(J.SSIM, T.SSIM, _ssim_preds.astype(dtype), _ssim_target.astype(dtype), metric_args, ddp,
               result_dtype=result_dtype, tol=tol)


@pytest.mark.parametrize("dtype, result_dtype, tol", _SSIM_DTYPES)
@pytest.mark.parametrize("metric_args", _SSIM_CASES)
def test_ssim_functional(metric_args, dtype, result_dtype, tol):
    for i in range(NUM_BATCHES):
        p, t = _ssim_preds[i].astype(dtype), _ssim_target[i].astype(dtype)
        got = TF.ssim(_t(p), _t(t), **metric_args)
        assert got.dtype == result_dtype
        _close(got, JF.ssim(jnp.asarray(p), jnp.asarray(t), **metric_args), **tol)


@pytest.mark.parametrize(
    "preds, target, kwargs",
    [
        (np.zeros((1, 1, 16, 16), np.float32), np.zeros((1, 1, 16, 16), np.float64), {}),
        (np.zeros((1, 16, 16), np.float32), np.zeros((1, 16, 16), np.float32), {}),
        (np.zeros((1, 1, 16, 16), np.float32), np.zeros((1, 1, 16, 16), np.float32), {"kernel_size": (10, 10)}),
        (np.zeros((1, 1, 16, 16), np.float32), np.zeros((1, 1, 16, 16), np.float32), {"sigma": (-1.5, 1.5)}),
        (np.zeros((1, 1, 16, 16), np.float32), np.zeros((1, 1, 16, 16), np.float32), {"kernel_size": (11,)}),
    ],
)
def test_ssim_invalid_inputs(preds, target, kwargs):
    with pytest.raises(Exception) as port_err:
        TF.ssim(_t(preds), _t(target), **kwargs)
    with pytest.raises(Exception) as jax_err:
        JF.ssim(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    assert type(port_err.value) is type(jax_err.value)
    assert str(port_err.value) == str(jax_err.value)


def test_ssim_identical_images_is_one():
    img = _rng.rand(4, 3, 32, 32).astype(np.float32)
    got = TF.ssim(_t(img), _t(img), data_range=1.0)
    np.testing.assert_allclose(float(got), 1.0, atol=1e-4)
    _close(got, JF.ssim(jnp.asarray(img), jnp.asarray(img), data_range=1.0))


def test_ssim_streaming_matches_buffered():
    rng = np.random.RandomState(51)
    # asymmetric kernel on non-square images: the element count follows the
    # actual cropped map
    for kernel_size, (h, w) in [((11, 11), (20, 20)), ((11, 7), (20, 40))]:
        streaming = T.SSIM(kernel_size=kernel_size, data_range=1.0, streaming=True, **CPU)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            buffered = T.SSIM(kernel_size=kernel_size, data_range=1.0, **CPU)
        jstreaming = J.SSIM(kernel_size=kernel_size, data_range=1.0, streaming=True)
        for _ in range(4):
            p = rng.rand(4, 3, h, w).astype(np.float32)
            t = (p * 0.8 + 0.1 * rng.rand(4, 3, h, w)).astype(np.float32)
            streaming.update(_t(p), _t(t))
            buffered.update(_t(p), _t(t))
            jstreaming.update(jnp.asarray(p), jnp.asarray(t))
        assert streaming.ssim_sum.dtype == torch.float64 and streaming.n_elements.dtype == torch.float64
        assert float(streaming.n_elements) == float(jstreaming.n_elements)
        got = streaming.compute()
        assert got.dtype == torch.float32
        _close(got, jstreaming.compute())
        np.testing.assert_allclose(float(got), float(buffered.compute()), atol=1e-6)

    for kwargs, match in (({}, "data_range"), ({"data_range": 1.0, "reduction": "none"}, "reduction")):
        with pytest.raises(ValueError, match=match) as port_err:
            T.SSIM(streaming=True, **kwargs, **CPU)
        with pytest.raises(ValueError) as jax_err:
            J.SSIM(streaming=True, **kwargs)
        assert str(port_err.value) == str(jax_err.value)

    # the compiled step: one program across steps
    metric = T.SSIM(data_range=1.0, streaming=True, compute_on_step=False, **CPU).jit_forward()
    for _ in range(3):
        p = torch.from_numpy(rng.rand(2, 1, 16, 16).astype(np.float32))
        metric(p, p)
    assert metric._jit_forward_fn.cache_info()["entries"] == 1
    np.testing.assert_allclose(float(metric.compute()), 1.0, atol=1e-5)

    # the sum reduction
    total, jtotal = T.SSIM(data_range=1.0, streaming=True, reduction="sum", **CPU), J.SSIM(
        data_range=1.0, streaming=True, reduction="sum")
    p, t = _ssim_preds[0], _ssim_target[0]
    total.update(_t(p), _t(t))
    jtotal.update(jnp.asarray(p), jnp.asarray(t))
    _close(total.compute(), jtotal.compute(), rtol=1e-6)


@pytest.mark.parametrize("form", ["band_matrix", "conv"])
def test_ssim_holds_against_both_jax_forms(monkeypatch, form):
    """The JAX package smooths with band-matrix matmuls (sides up to 1024)
    or two depthwise convolutions (above); the port always convolves. Both
    forms, asymmetric kernels, non-square images, and tiny images whose side
    is at most the pad (the reflect bounces more than once)."""
    if form == "conv":
        monkeypatch.setattr(jax_ssim_module, "_MATMUL_MAX_SIDE", 0)
    rng = np.random.RandomState(3)
    a = rng.rand(2, 3, 31, 45).astype(np.float32)
    b = rng.rand(2, 3, 31, 45).astype(np.float32)
    tiny = rng.rand(2, 3, 4, 5).astype(np.float32)
    tiny2 = rng.rand(2, 3, 4, 5).astype(np.float32)
    configs = [((11, 11), (1.5, 1.5)), ((11, 7), (1.5, 0.8)), ((3, 9), (0.7, 2.0))]
    cases = [(a, b, ks, sg) for ks, sg in configs] + [(tiny, tiny2, (5, 5), (1.5, 1.5)),
                                                      (tiny, tiny2, (11, 11), (1.5, 1.5))]
    for x, y, ks, sg in cases:
        for dtype, tol in ((np.float32, SSIM_F32), (np.float64, F64)):
            for reduction in ("elementwise_mean", "none"):
                kw = dict(kernel_size=ks, sigma=sg, data_range=1.0, reduction=reduction)
                got = TF.ssim(_t(x.astype(dtype)), _t(y.astype(dtype)), **kw)
                want = JF.ssim(jnp.asarray(x.astype(dtype)), jnp.asarray(y.astype(dtype)), **kw)
                assert tuple(got.shape) == want.shape
                np.testing.assert_allclose(got.numpy(), np.asarray(want), equal_nan=True, **tol)


@pytest.mark.parametrize("size, pad", [(5, 2), (4, 5), (1, 3), (2, 7), (24, 5)])
def test_reflect_index_bounces_as_jnp_pad_does(size, pad):
    want = np.asarray(jnp.pad(jnp.arange(size), pad, mode="reflect"))
    np.testing.assert_array_equal(_reflect_index(size, pad, torch.device("cpu")).numpy(), want)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_precision_ssim(dtype):
    rng = np.random.RandomState(33)
    rng.randn(256), rng.randn(256)  # the draws of the regression inputs come first, as in test_dtypes.py
    imgs_p = rng.rand(2, 1, 24, 24).astype(np.float32)
    imgs_t = np.clip(imgs_p * 0.9 + 0.05, 0, 1).astype(np.float32)
    full = TF.ssim(_t(imgs_p), _t(imgs_t), data_range=1.0)
    half = TF.ssim(_t(imgs_p).to(getattr(torch, dtype)), _t(imgs_t).to(getattr(torch, dtype)), data_range=1.0)
    jax_half = JF.ssim(jnp.asarray(imgs_p, dtype=dtype), jnp.asarray(imgs_t, dtype=dtype), data_range=1.0)
    np.testing.assert_allclose(float(half), float(full), atol=0.02)
    np.testing.assert_allclose(float(half), float(jax_half), atol=0.02)


# -- the deprecated aliases -------------------------------------------------------------


@pytest.mark.parametrize("name, kwargs", [("PSNR", {"data_range": 3.0}), ("SSIM", {"data_range": 1.0})])
def test_regression_aliases_warn_and_equal_the_image_metrics(name, kwargs):
    import metrics_tpu.regression as JR

    with pytest.warns(DeprecationWarning, match=f"`{name}` was moved to `metrics_tpu_torch.image"):
        alias = getattr(TR, name)(**kwargs, **CPU)
    with pytest.warns(DeprecationWarning, match=f"`{name}` was moved to `metrics_tpu.image"):
        getattr(JR, name)(**kwargs)
    assert isinstance(alias, getattr(T, name)) and getattr(T, name) is getattr(T.image, name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        image = getattr(T, name)(**kwargs, **CPU)
    preds, target = (_psnr_preds[0], _psnr_target[0]) if name == "PSNR" else (_ssim_preds[0], _ssim_target[0])
    torch.testing.assert_close(alias(_t(preds), _t(target)), image(_t(preds), _t(target)), rtol=0, atol=0)


def test_keyed_running_range_psnr_routes_its_extremal_leaves():
    """A keyed ``PSNR()`` keys its ``min_target``/``max_target`` leaves
    (``"min"``/``"max"``, the extremal kernel's route) and its sums."""
    rng = np.random.RandomState(9)
    port, ref = T.KeyedMetric(T.PSNR(**CPU), 3, **CPU), J.KeyedMetric(J.PSNR(), 3)
    for _ in range(3):
        ids = rng.randint(0, 3, 12)
        p, t = rng.rand(12, 4).astype(np.float32) * 2, rng.rand(12, 4).astype(np.float32) * 2 - 0.5
        port.update(_t(ids), _t(p), _t(t))
        ref.update(jnp.asarray(ids), jnp.asarray(p), jnp.asarray(t))
    for name in ("min_target", "max_target", "total"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    _close(port.sum_squared_error, ref.sum_squared_error)
    _close(port.compute(), ref.compute())



# -- integer images -------------------------------------------------------------------


def _int_image_pair():
    rs = np.random.RandomState(0)
    return rs.randint(0, 255, (1, 1, 16, 16)), rs.randint(0, 255, (1, 1, 16, 16))


@pytest.mark.parametrize("data_range", [None, 255.0])
def test_ssim_on_integer_images_computes_in_float32_where_the_jax_window_truncates(data_range):
    """Two random int64 images: the port computes in float32 and gives the
    float64 pair's value (-0.088029 with the range taken from the data,
    -0.087978 with ``data_range=255``), functional and module (buffered and
    streaming). The JAX package builds its window in the images' integer
    dtype, where it truncates to zeros, and returns 1.0 for any pair: a
    fault of the reference, pinned here as such."""
    a, b = _int_image_pair()
    kwargs = {} if data_range is None else {"data_range": data_range}
    want = float(TF.ssim(_t(a.astype(np.float64)), _t(b.astype(np.float64)), **kwargs))
    np.testing.assert_allclose(want, -0.088029 if data_range is None else -0.087978, atol=1e-6)
    np.testing.assert_allclose(float(JF.ssim(jnp.asarray(a.astype(np.float64)), jnp.asarray(b.astype(np.float64)),
                                             **kwargs)), want, **F64)
    got = TF.ssim(_t(a), _t(b), **kwargs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, **SSIM_F32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        buffered = T.SSIM(**kwargs, **CPU)
        buffered.update(_t(a), _t(b))
        assert buffered.compute().dtype == torch.float32
        np.testing.assert_allclose(float(buffered.compute()), want, **SSIM_F32)
        if data_range is not None:
            streaming = T.SSIM(streaming=True, **kwargs, **CPU)
            streaming.update(_t(a), _t(b))
            np.testing.assert_allclose(float(streaming.compute()), want, **SSIM_F32)
    # the reference's fault: its integer window is all zeros, so SSIM is 1.0
    assert float(JF.ssim(jnp.asarray(a), jnp.asarray(b), **kwargs)) == 1.0
