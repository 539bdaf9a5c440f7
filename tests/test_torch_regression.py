"""The port's regression family against the JAX package's.

Mirrors ``tests/regression/test_regression.py`` case by case (its 26
functions with their parametrisations) and ``tests/regression/test_dtypes.py``:
the same seeded numpy inputs (``tests/regression/inputs.py``'s fixtures and
``np.random.RandomState``) go through the ``metrics_tpu`` object and its
``metrics_tpu_torch`` counterpart (``device="cpu"``). The module metrics run
``forward`` on every batch and ``compute`` at the end; the ``ddp=True``
cases stripe the batches over two ranks simulated by threads
(``tests/test_torch_distributed.py::_run_ranks``) and compare the synced
``compute()`` with the JAX package's ``sharded_compute`` of the same stripes.

Tolerances, by the port's result dtype: float32 values within
``rtol=atol=1e-6`` (the port keeps float32 value sums where the JAX side, with
x64 on, keeps float64), float64 values within ``rtol=atol=1e-12``. Dtypes are
asserted apart from the values. One gradient case per functional regression
metric holds ``torch.autograd`` against ``jax.grad`` on float64 inputs.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import rankdata, spearmanr

import metrics_tpu as J
import metrics_tpu.functional as JF
import metrics_tpu_torch as T
import metrics_tpu_torch.functional as TF
from metrics_tpu.functional.regression.spearman import _masked_rank as j_masked_rank
from metrics_tpu.functional.regression.spearman import _rank_data as j_rank_data
from metrics_tpu.functional.regression.spearman import masked_spearman_corrcoef as j_masked_spearman
from metrics_tpu_torch.functional.regression.spearman import _masked_rank, _rank_data, masked_spearman_corrcoef
from tests.helpers.testers import NUM_BATCHES, sharded_compute
from tests.regression.inputs import NUM_OUTPUTS, _multi_target_inputs, _single_target_inputs
from tests.test_torch_distributed import _run_ranks

CPU = {"device": "cpu"}
F32 = dict(rtol=1e-6, atol=1e-6)
F64 = dict(rtol=1e-12, atol=1e-12)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, equal_nan=False):
    """``got`` (the port's) against ``want`` (the JAX package's), at the
    tolerance of the port's dtype."""
    assert isinstance(got, torch.Tensor)
    tol = F64 if got.dtype == torch.float64 else F32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64), equal_nan=equal_nan, **tol)


def _synced_compute(m):
    """``m.compute()`` over the states of every simulated rank."""
    with m.sync_context(distributed_available=lambda: True):
        return m.compute()


def _run_class(jax_cls, port_cls, preds, target, args, ddp, check_batch=True, result_dtype=torch.float32):
    """``forward`` per batch and ``compute`` (or two ranks' synced compute)
    of the JAX and the port metric on the same batches."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if not ddp:
            jm, tm = jax_cls(**args), port_cls(**args, **CPU)
            for i in range(NUM_BATCHES):
                got = tm(_t(preds[i]), _t(target[i]))
                want = jm(jnp.asarray(preds[i]), jnp.asarray(target[i]))
                if check_batch:
                    _close(got, want)
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
            assert errors == [None, None]
            assert calls[0] == calls[1] > 0
            torch.testing.assert_close(results[0], results[1], rtol=0, atol=0)
            got = results[0]
    assert got.dtype == result_dtype
    _close(got, want)


def _run_functional(jax_fn, port_fn, preds, target, args=None):
    args = args or {}
    for i in range(NUM_BATCHES):
        got = port_fn(_t(preds[i]), _t(target[i]), **args)
        want = jax_fn(jnp.asarray(preds[i]), jnp.asarray(target[i]), **args)
        assert got.dtype == torch.float64  # float64 inputs keep their precision
        _close(got, want)


# -- the mean errors ----------------------------------------------------------------

_MEAN_ERROR_CASES = [
    pytest.param("MeanSquaredError", "mean_squared_error", {}, id="mse"),
    pytest.param("MeanSquaredError", "mean_squared_error", {"squared": False}, id="rmse"),
    pytest.param("MeanAbsoluteError", "mean_absolute_error", {}, id="mae"),
    pytest.param("MeanSquaredLogError", "mean_squared_log_error", {}, id="msle"),
    pytest.param("MeanAbsolutePercentageError", "mean_absolute_percentage_error", {}, id="mape"),
]


@pytest.mark.parametrize("cls, fn, args", _MEAN_ERROR_CASES)
@pytest.mark.parametrize("ddp", [False, True])
def test_mean_error_class(ddp, cls, fn, args):
    _run_class(getattr(J, cls), getattr(T, cls), _single_target_inputs.preds, _single_target_inputs.target, args, ddp)


@pytest.mark.parametrize("cls, fn, args", _MEAN_ERROR_CASES)
def test_mean_error_functional(cls, fn, args):
    _run_functional(getattr(JF, fn), getattr(TF, fn), _single_target_inputs.preds, _single_target_inputs.target, args)


@pytest.mark.parametrize("cls, fn, args", _MEAN_ERROR_CASES)
def test_mean_error_states_and_dtypes(cls, fn, args):
    m = getattr(T, cls)(**args, **CPU)
    names = [n for n in m._defaults if n != "total"]
    assert len(names) == 1 and m._defaults[names[0]].dtype == torch.float32
    assert m._defaults["total"].dtype == torch.int64
    assert {m._reductions[n] for n in m._defaults} == {"sum"}
    m.update(_t(_single_target_inputs.preds[0]), _t(_single_target_inputs.target[0]))
    assert getattr(m, names[0]).dtype == torch.float32 and m.total.dtype == torch.int64
    assert int(m.total) == _single_target_inputs.preds[0].size


def test_mean_relative_error():
    preds = _single_target_inputs.preds[0]
    target = _single_target_inputs.target[0]
    with pytest.warns(DeprecationWarning, match="mean_relative_error") as port_warn:
        got = TF.mean_relative_error(_t(preds), _t(target))
    with pytest.warns(DeprecationWarning) as jax_warn:
        want = JF.mean_relative_error(jnp.asarray(preds), jnp.asarray(target))
    assert str(port_warn[0].message) == str(jax_warn[0].message)
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), np.mean(np.abs(preds - target) / np.abs(target)), atol=1e-6)


def test_mean_squared_log_error_negative_is_nan():
    got = TF.mean_squared_log_error(torch.tensor([-2.0, 2.0]), torch.tensor([1.0, 2.0]))
    want = JF.mean_squared_log_error(jnp.asarray([-2.0, 2.0]), jnp.asarray([1.0, 2.0]))
    assert bool(torch.isnan(got)) and bool(jnp.isnan(want))
    # above -1 the log is defined on both sides and agrees
    _close(TF.mean_squared_log_error(torch.tensor([-0.5, 2.0]), torch.tensor([1.0, 2.0])),
           JF.mean_squared_log_error(jnp.asarray([-0.5, 2.0]), jnp.asarray([1.0, 2.0])))


# -- explained variance and R2 -----------------------------------------------------


@pytest.mark.parametrize("multioutput", ["raw_values", "uniform_average", "variance_weighted"])
@pytest.mark.parametrize("ddp", [False, True])
def test_explained_variance_class_multi(ddp, multioutput):
    _run_class(J.ExplainedVariance, T.ExplainedVariance, _multi_target_inputs.preds, _multi_target_inputs.target,
               {"multioutput": multioutput}, ddp)


@pytest.mark.parametrize("multioutput", ["raw_values", "uniform_average", "variance_weighted"])
def test_explained_variance_functional(multioutput):
    _run_functional(JF.explained_variance, TF.explained_variance, _multi_target_inputs.preds,
                    _multi_target_inputs.target, {"multioutput": multioutput})


@pytest.mark.parametrize("ddp", [False, True])
@pytest.mark.parametrize("multioutput", ["raw_values", "uniform_average", "variance_weighted"])
def test_r2score_class_multi(ddp, multioutput):
    _run_class(J.R2Score, T.R2Score, _multi_target_inputs.preds, _multi_target_inputs.target,
               {"num_outputs": NUM_OUTPUTS, "multioutput": multioutput}, ddp)


@pytest.mark.parametrize("ddp", [False, True])
def test_r2score_class_single(ddp):
    _run_class(J.R2Score, T.R2Score, _single_target_inputs.preds, _single_target_inputs.target, {}, ddp)


def test_r2score_adjusted():
    preds = _single_target_inputs.preds.reshape(-1)
    target = _single_target_inputs.target.reshape(-1)
    for k in (1, 3):
        _close(TF.r2score(_t(preds), _t(target), adjusted=k), JF.r2score(jnp.asarray(preds), jnp.asarray(target),
                                                                          adjusted=k))
    n = preds.size
    for k, match in ((n, "More independent regressions"), (n - 1, "Division by zero")):
        with pytest.warns(UserWarning, match=match):
            got = TF.r2score(_t(preds), _t(target), adjusted=k)
        _close(got, JF.r2score(jnp.asarray(preds), jnp.asarray(target)))
    m, jm = T.R2Score(adjusted=2, **CPU), J.R2Score(adjusted=2)
    m.update(_t(preds), _t(target))
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    _close(m.compute(), jm.compute())


@pytest.mark.parametrize(
    "cls, kwargs",
    [
        ("R2Score", {"adjusted": -1}),
        ("R2Score", {"multioutput": "max"}),
        ("ExplainedVariance", {"multioutput": "max"}),
        ("CosineSimilarity", {"reduction": "max"}),
        ("CosineSimilarity", {"reduction": "none", "streaming": True}),
    ],
)
def test_bad_arguments_raise_as_the_jax_package_does(cls, kwargs):
    with pytest.raises(ValueError) as port_err:
        getattr(T, cls)(**kwargs, **CPU)
    with pytest.raises(ValueError) as jax_err:
        getattr(J, cls)(**kwargs)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize(
    "fn, preds, target",
    [
        ("r2score", np.zeros((1,)), np.zeros((1,))),
        ("r2score", np.zeros((2, 2, 2)), np.zeros((2, 2, 2))),
        ("pearson_corrcoef", np.zeros((4, 2)), np.zeros((4, 2))),
        ("spearman_corrcoef", np.zeros((4, 2)), np.zeros((4, 2))),
        ("spearman_corrcoef", np.zeros(4, np.float32), np.zeros(4, np.float64)),
        ("mean_squared_error", np.zeros(4), np.zeros(5)),
    ],
)
def test_functional_input_errors_match_the_jax_package(fn, preds, target):
    with pytest.raises(Exception) as port_err:
        getattr(TF, fn)(_t(preds), _t(target))
    with pytest.raises(Exception) as jax_err:
        getattr(JF, fn)(jnp.asarray(preds), jnp.asarray(target))
    assert type(port_err.value) is type(jax_err.value)
    assert str(port_err.value) == str(jax_err.value)


# -- the correlation coefficients -----------------------------------------------------


@pytest.mark.parametrize("ddp", [False, True])
def test_pearson_class(ddp):
    _run_class(J.PearsonCorrcoef, T.PearsonCorrcoef, _single_target_inputs.preds, _single_target_inputs.target, {},
               ddp, result_dtype=torch.float64)


@pytest.mark.parametrize("ddp", [False, True])
def test_spearman_class(ddp):
    _run_class(J.SpearmanCorrcoef, T.SpearmanCorrcoef, _single_target_inputs.preds, _single_target_inputs.target,
               {}, ddp, result_dtype=torch.float64)


def test_pearson_functional():
    _run_functional(JF.pearson_corrcoef, TF.pearson_corrcoef, _single_target_inputs.preds,
                    _single_target_inputs.target)


def test_spearman_functional():
    _run_functional(JF.spearman_corrcoef, TF.spearman_corrcoef, _single_target_inputs.preds,
                    _single_target_inputs.target)


def test_spearman_with_ties():
    preds = np.asarray([1.0, 2.0, 2.0, 2.0, 3.0, 4.0, 4.0, 5.0])
    target = np.asarray([3.0, 1.0, 1.0, 2.0, 2.0, 4.0, 5.0, 5.0])
    got = TF.spearman_corrcoef(_t(preds), _t(target))
    _close(got, JF.spearman_corrcoef(jnp.asarray(preds), jnp.asarray(target)))
    np.testing.assert_allclose(got.numpy(), spearmanr(target, preds)[0], atol=1e-6)
    np.testing.assert_array_equal(_rank_data(_t(preds)).numpy(), np.asarray(j_rank_data(jnp.asarray(preds))))


# -- cosine similarity ------------------------------------------------------------------


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("ddp", [False, True])
def test_cosine_similarity_class(ddp, reduction):
    _run_class(J.CosineSimilarity, T.CosineSimilarity, _multi_target_inputs.preds, _multi_target_inputs.target,
               {"reduction": reduction}, ddp, result_dtype=torch.float64)


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_cosine_similarity_functional(reduction):
    _run_functional(JF.cosine_similarity, TF.cosine_similarity, _multi_target_inputs.preds,
                    _multi_target_inputs.target, {"reduction": reduction})
    # float32 and integer inputs compute in float32, as the JAX package's
    p, t = _multi_target_inputs.preds[0], _multi_target_inputs.target[0]
    for cast in (lambda a: a.astype(np.float32), lambda a: (a * 10).astype(np.int32)):
        got = TF.cosine_similarity(_t(cast(p)), _t(cast(t)), reduction)
        want = JF.cosine_similarity(jnp.asarray(cast(p)), jnp.asarray(cast(t)), reduction)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        _close(got, want)



@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_pearson_on_integer_inputs_computes_in_float32(dtype):
    """Integer pairs: the functional and the list-mode module compute in
    float32 (``torch.mean`` refuses integers, ``jnp.mean`` promotes them) and
    give the JAX package's value, 0.094066, within float32 rounding; the
    streaming module keeps its float64 sums."""
    rs = np.random.RandomState(0)
    preds, target = rs.randint(0, 100, 50).astype(dtype), rs.randint(0, 100, 50).astype(dtype)
    want = JF.pearson_corrcoef(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_allclose(float(want), 0.094066, atol=1e-6)
    got = TF.pearson_corrcoef(_t(preds), _t(target))
    assert got.dtype == torch.float32
    _close(got, want)
    for streaming, result_dtype in ((False, torch.float32), (True, torch.float64)):
        m, ref = T.PearsonCorrcoef(streaming=streaming, **CPU), J.PearsonCorrcoef(streaming=streaming)
        for half in (slice(0, 25), slice(25, 50)):
            m.update(_t(preds[half]), _t(target[half]))
            ref.update(jnp.asarray(preds[half]), jnp.asarray(target[half]))
        value = m.compute()
        assert value.dtype == result_dtype
        _close(value, ref.compute())
        np.testing.assert_allclose(float(value), float(want), **F32)


# -- the streaming modes --------------------------------------------------------------


def test_pearson_streaming_matches_buffered():
    rng = np.random.RandomState(31)
    pairs = [(m, J.PearsonCorrcoef(streaming=s)) for m, s in ((T.PearsonCorrcoef(streaming=True, **CPU), True),
                                                              (T.PearsonCorrcoef(**CPU), False))]
    for _ in range(6):
        p = rng.randn(40)
        t = rng.randn(40) * 0.5 + p
        for tm, jm in pairs:
            tm.update(_t(p), _t(t))
            jm.update(jnp.asarray(p), jnp.asarray(t))
    (streaming, jstreaming), (buffered, jbuffered) = pairs
    assert all(getattr(streaming, n).dtype == torch.float64 for n in ("sum_x", "sum_y", "sum_xx", "sum_yy", "sum_xy"))
    assert streaming.n_total.dtype == torch.int32
    got, got_buf = streaming.compute(), buffered.compute()
    assert got.dtype == torch.float64 and got_buf.dtype == torch.float64
    _close(got, jstreaming.compute())
    _close(got_buf, jbuffered.compute())
    np.testing.assert_allclose(got.numpy(), got_buf.numpy(), atol=1e-13)

    # float32 inputs: the buffered path computes in float32, streaming
    # still accumulates float64
    s32, b32 = T.PearsonCorrcoef(streaming=True, **CPU), T.PearsonCorrcoef(**CPU)
    js32 = J.PearsonCorrcoef(streaming=True)
    for _ in range(4):
        p = rng.randn(40).astype(np.float32)
        t = (rng.randn(40) * 0.5 + p).astype(np.float32)
        for m in (s32, b32):
            m.update(_t(p), _t(t))
        js32.update(jnp.asarray(p), jnp.asarray(t))
    assert b32.compute().dtype == torch.float32
    np.testing.assert_allclose(float(s32.compute()), float(b32.compute()), atol=1e-6)
    _close(s32.compute(), js32.compute())

    # the compiled step: one program for every step (no new signature)
    metric = T.PearsonCorrcoef(streaming=True, **CPU).jit_forward()
    for _ in range(4):
        p = torch.from_numpy(rng.randn(16).astype(np.float32))
        metric(p, p * 2)
    assert metric._jit_forward_fn.cache_info()["entries"] == 1
    np.testing.assert_allclose(float(metric.compute()), 1.0, atol=1e-5)


def test_pearson_streaming_sharded():
    rng = np.random.RandomState(32)
    n = 8 * 16
    preds = rng.randn(n).astype(np.float32)
    target = (rng.randn(n) * 0.3 + preds).astype(np.float32)
    whole = T.PearsonCorrcoef(streaming=True, **CPU)
    whole.update(_t(preds), _t(target))

    def rank(r):
        def run():
            m = T.PearsonCorrcoef(streaming=True, **CPU)
            m.update(_t(preds[r::2]), _t(target[r::2]))
            return _synced_compute(m)

        return run

    results, errors, _ = _run_ranks([rank(0), rank(1)], "torch")
    assert errors == [None, None]
    np.testing.assert_allclose(float(results[0]), float(whole.compute()), atol=1e-12)
    jm = J.PearsonCorrcoef(streaming=True)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    _close(results[0], jm.compute())


def test_pearson_streaming_edge_cases():
    rng_target = np.random.RandomState(33).randn(50).astype(np.float32)
    cases = [
        [(np.full((50,), 1000.0, np.float32), rng_target)],  # constant preds: correlation 0
        [(np.asarray([1.5]), np.asarray([2.0])), (np.asarray([2.5]), np.asarray([3.0]))],  # 1-row batches
        [(np.linspace(0, 1, 100), np.linspace(0, 1, 100) * 3 + 1)],  # clipped to [-1, 1]
    ]
    for batches in cases:
        tm, jm = T.PearsonCorrcoef(streaming=True, **CPU), J.PearsonCorrcoef(streaming=True)
        for p, t in batches:
            tm.update(_t(p), _t(t))
            jm.update(jnp.asarray(p), jnp.asarray(t))
        got = tm.compute()
        assert -1.0 <= float(got) <= 1.0
        _close(got, jm.compute())
    np.testing.assert_allclose(float(got), 1.0, atol=1e-5)


def test_cosine_streaming_matches_buffered():
    rng = np.random.RandomState(41)
    for reduction in ("sum", "mean"):
        streaming = T.CosineSimilarity(reduction=reduction, streaming=True, **CPU)
        buffered = T.CosineSimilarity(reduction=reduction, **CPU)
        jstreaming = J.CosineSimilarity(reduction=reduction, streaming=True)
        for _ in range(5):
            p, t = rng.randn(16, 8), rng.randn(16, 8)
            streaming.update(_t(p), _t(t))
            buffered.update(_t(p), _t(t))
            jstreaming.update(jnp.asarray(p), jnp.asarray(t))
        assert streaming.sim_sum.dtype == torch.float32 and streaming.n_total.dtype == torch.int32
        got = streaming.compute()
        assert got.dtype == torch.float32
        _close(got, jstreaming.compute())
        np.testing.assert_allclose(float(got), float(buffered.compute()), rtol=1e-6, atol=1e-6)

    with pytest.raises(ValueError, match="streaming"):
        T.CosineSimilarity(reduction="none", streaming=True, **CPU)

    # the fused forward and the compiled step (one program across steps)
    metric = T.CosineSimilarity(reduction="mean", streaming=True, **CPU).jit_forward()
    oracle = J.CosineSimilarity(reduction="mean")
    for _ in range(4):
        p = rng.randn(8, 4).astype(np.float32)
        t = rng.randn(8, 4).astype(np.float32)
        metric(_t(p), _t(t))
        oracle.update(jnp.asarray(p), jnp.asarray(t))
    assert metric._jit_forward_fn.cache_info()["entries"] == 1
    np.testing.assert_allclose(float(metric.compute()), float(oracle.compute()), atol=1e-6)


def test_cosine_streaming_higher_rank_inputs():
    rng = np.random.RandomState(42)
    p = rng.randn(4, 5, 8).astype(np.float32)
    t = rng.randn(4, 5, 8).astype(np.float32)
    streaming = T.CosineSimilarity(reduction="mean", streaming=True, **CPU)
    buffered = T.CosineSimilarity(reduction="mean", **CPU)
    jm = J.CosineSimilarity(reduction="mean", streaming=True)
    streaming.update(_t(p), _t(t))
    buffered.update(_t(p), _t(t))
    jm.update(jnp.asarray(p), jnp.asarray(t))
    assert int(streaming.n_total) == 20
    np.testing.assert_allclose(float(streaming.compute()), float(buffered.compute()), atol=1e-6)
    _close(streaming.compute(), jm.compute())


# -- Spearman's capacity mode and the masked rank ----------------------------------------


def test_spearman_capacity_mode():
    rng = np.random.RandomState(61)

    # masked kernel vs the JAX package's and scipy, with heavy ties and padding
    n, cap = 150, 200
    preds = np.round(rng.rand(n), 1).astype(np.float32)
    target = np.round(rng.rand(n), 1).astype(np.float32)
    pp = np.zeros(cap, np.float32)
    pp[:n] = preds
    tt = np.zeros(cap, np.float32)
    tt[:n] = target
    valid = np.arange(cap) < n
    got = masked_spearman_corrcoef(_t(pp), _t(tt), _t(valid))
    assert got.dtype == torch.float32
    _close(got, j_masked_spearman(jnp.asarray(pp), jnp.asarray(tt), jnp.asarray(valid)))
    np.testing.assert_allclose(float(got), spearmanr(preds, target).statistic, atol=1e-4)

    # adversarial rank edges: padding ties with the max valid value, and a
    # literal +inf is a real sample; neither may group with padding
    data = np.asarray([3.0, 1.0, 3.0, 2.0, np.inf, 3.0, 7.0])
    valid_edges = np.asarray([True, True, True, True, True, False, False])
    ranks = _masked_rank(_t(data), _t(valid_edges)).numpy()
    np.testing.assert_array_equal(ranks[:5], np.asarray(j_masked_rank(jnp.asarray(data), jnp.asarray(valid_edges)))[:5])
    np.testing.assert_allclose(ranks[:5], rankdata(data[:5]))

    # the capacity metric accumulates across batches and matches list mode
    capped, listed = T.SpearmanCorrcoef(capacity=256, **CPU), J.SpearmanCorrcoef()
    jcapped = J.SpearmanCorrcoef(capacity=256)
    for _ in range(5):
        p = rng.randn(32).astype(np.float32)
        t = (rng.randn(32) * 0.5 + p).astype(np.float32)
        capped.update(_t(p), _t(t))
        listed.update(jnp.asarray(p), jnp.asarray(t))
        jcapped.update(jnp.asarray(p), jnp.asarray(t))
    assert capped.buf.dtype == torch.float32 and capped.count.dtype == torch.int32
    np.testing.assert_array_equal(capped.buf.numpy(), np.asarray(jcapped.buf))
    _close(capped.compute(), jcapped.compute())
    np.testing.assert_allclose(float(capped.compute()), float(listed.compute()), atol=1e-4)

    # the compiled step: one program across steps, no host read
    metric = T.SpearmanCorrcoef(capacity=128, compute_on_step=False, **CPU)
    for _ in range(4):
        p = torch.from_numpy(rng.randn(4, 16).astype(np.float32))
        metric.update_many(p, p * 2 + 1)
    assert metric._update_many_fn.cache_info()["entries"] == 1
    np.testing.assert_allclose(float(metric.compute()), 1.0, atol=1e-5)

    # overflow warns and covers the first `capacity` samples
    small, jsmall = T.SpearmanCorrcoef(capacity=32, **CPU), J.SpearmanCorrcoef(capacity=32)
    p = rng.randn(50).astype(np.float32)
    t = (rng.randn(50) * 0.1 + p).astype(np.float32)
    small.update(_t(p), _t(t))
    jsmall.update(jnp.asarray(p), jnp.asarray(t))
    with pytest.warns(UserWarning, match="dropped"):
        value = small.compute()
    with pytest.warns(UserWarning, match="dropped"):
        _close(value, jsmall.compute())
    np.testing.assert_allclose(float(value), spearmanr(p[:32], t[:32]).statistic, atol=1e-4)


def test_spearman_capacity_sharded():
    rng = np.random.RandomState(62)
    n = 8 * 24
    preds = rng.randn(n).astype(np.float32)
    target = (rng.randn(n) * 0.4 + preds).astype(np.float32)

    def rank(r):
        def run():
            m = T.SpearmanCorrcoef(capacity=n // 2, **CPU)
            m.update(_t(preds[r * n // 2:(r + 1) * n // 2]), _t(target[r * n // 2:(r + 1) * n // 2]))
            return _synced_compute(m)

        return run

    results, errors, _ = _run_ranks([rank(0), rank(1)], "torch")
    assert errors == [None, None]
    np.testing.assert_allclose(float(results[0]), spearmanr(preds, target).statistic, atol=1e-4)
    whole = J.SpearmanCorrcoef(capacity=n)
    whole.update(jnp.asarray(preds), jnp.asarray(target))
    _close(results[0], whole.compute())


def test_masked_rank_inf_value_vs_padding():
    preds = np.array([0.1, 0.5, np.inf, 0.3, 0.2] + [0.0] * 11, np.float32)
    target = np.array([1.0, 2.0, 5.0, 1.5, 1.2] + [0.0] * 11, np.float32)
    valid = np.arange(16) < 5
    got = masked_spearman_corrcoef(_t(preds), _t(target), _t(valid))
    _close(got, j_masked_spearman(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(valid)))
    np.testing.assert_allclose(float(got), 1.0, atol=1e-6)


def test_rank_data_precision_and_integer_ties():
    # integer inputs keep fractional tie ranks
    got = TF.spearman_corrcoef(torch.tensor([1, 1, 2, 3], dtype=torch.int32).float(),
                               torch.tensor([1, 2, 3, 3], dtype=torch.int32).float())
    np.testing.assert_allclose(float(got), spearmanr([1, 1, 2, 3], [1, 2, 3, 3]).statistic, atol=1e-6)
    ranks = _rank_data(torch.tensor([1, 1, 2, 3], dtype=torch.int32))
    want = j_rank_data(jnp.asarray([1, 1, 2, 3], jnp.int32))
    assert ranks.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(ranks.numpy(), [1.5, 1.5, 3.0, 4.0])

    # float64 values that differ below float32 precision must not tie, and
    # ranks beyond 2^23 stay exact in float64
    data = np.asarray([16777216.0, 16777217.0, 0.0])
    ranks = _rank_data(torch.tensor(data, dtype=torch.float64))
    assert ranks.dtype == torch.float64
    np.testing.assert_array_equal(ranks.numpy(), [2.0, 3.0, 1.0])
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(j_rank_data(jnp.asarray(data, jnp.float64))))


@pytest.mark.parametrize("seed", range(4))
def test_masked_rank_fuzz_matches_the_jax_package(seed):
    """Random ties, NaN, +-inf, -0.0 and masks: the same ranks on every valid slot."""
    rng = np.random.RandomState(100 + seed)
    n = 257
    data = np.round(rng.randn(n), 1)
    data[rng.rand(n) < 0.05] = np.inf
    data[rng.rand(n) < 0.05] = -np.inf
    data[rng.rand(n) < 0.05] = -0.0
    valid = rng.rand(n) < 0.8
    for dtype in (np.float32, np.float64):
        x = data.astype(dtype)
        got = _masked_rank(_t(x), _t(valid)).numpy()
        want = np.asarray(j_masked_rank(jnp.asarray(x), jnp.asarray(valid)))
        np.testing.assert_array_equal(got[valid], want[valid])
        np.testing.assert_allclose(got[valid], rankdata(x[valid]))


# -- half precision (tests/regression/test_dtypes.py) -------------------------------------

_rng = np.random.RandomState(33)
_N = 256
_preds = _rng.randn(_N).astype(np.float32)
_target = (_preds * 0.8 + 0.1 * _rng.randn(_N)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize(
    "fn, shape, kwargs",
    [
        ("mean_squared_error", (_N,), {}),
        ("mean_absolute_error", (_N,), {}),
        ("explained_variance", (_N,), {}),
        ("r2score", (_N,), {}),
        ("pearson_corrcoef", (_N,), {}),
        ("spearman_corrcoef", (_N,), {}),
        ("cosine_similarity", (16, 16), {}),
        ("psnr", (_N,), {"data_range": 4.0}),
    ],
)
def test_half_precision_matches_f32(dtype, fn, shape, kwargs):
    p, t = _preds.reshape(shape), _target.reshape(shape)
    full = getattr(TF, fn)(_t(p), _t(t), **kwargs)
    half = getattr(TF, fn)(_t(p).to(getattr(torch, dtype)), _t(t).to(getattr(torch, dtype)), **kwargs)
    jax_half = getattr(JF, fn)(jnp.asarray(p, dtype=dtype), jnp.asarray(t, dtype=dtype), **kwargs)
    assert bool(torch.isfinite(half.float()).all())
    half64 = half.double().numpy()
    # half-precision rounding moves sums, not semantics: 2% slack, as in
    # the JAX package's test, against the float32 value and its half value
    np.testing.assert_allclose(half64, full.double().numpy(), rtol=0.02, atol=0.02)
    np.testing.assert_allclose(half64, np.asarray(jax_half, np.float64), rtol=0.02, atol=0.02)


# -- gradients (tests/functional/test_differentiability.py and the mean errors') ------------

_grng = np.random.RandomState(19)
_reg_preds = _grng.randn(16)
_reg_target = _reg_preds * 0.8 + 0.3 * _grng.randn(16)
_vec_preds = _grng.randn(16, 4)
_vec_target = _grng.randn(16, 4)
_pos_preds = _grng.rand(16) + 0.1
_pos_target = _grng.rand(16) + 0.1
_img_a = _grng.rand(2, 1, 24, 24)
_img_b = np.clip(_img_a + 0.1 * _grng.randn(2, 1, 24, 24), 0, 1)

_GRAD_CASES = [
    pytest.param("mean_squared_error", _reg_preds, _reg_target, {}, id="mse"),
    pytest.param("mean_squared_error", _reg_preds, _reg_target, {"squared": False}, id="rmse"),
    pytest.param("mean_absolute_error", _reg_preds, _reg_target, {}, id="mae"),
    pytest.param("mean_squared_log_error", _pos_preds, _pos_target, {}, id="msle"),
    pytest.param("mean_absolute_percentage_error", _reg_preds, _reg_target, {}, id="mape"),
    pytest.param("cosine_similarity", _vec_preds, _vec_target, {}, id="cosine"),
    pytest.param("explained_variance", _reg_preds, _reg_target, {}, id="explained_variance"),
    pytest.param("r2score", _reg_preds, _reg_target, {}, id="r2score"),
    pytest.param("pearson_corrcoef", _reg_preds, _reg_target, {}, id="pearson"),
    pytest.param("spearman_corrcoef", _reg_preds, _reg_target, {}, id="spearman"),
    pytest.param("psnr", _pos_preds, _pos_target, {"data_range": 1.0}, id="psnr"),
    pytest.param("ssim", _img_a, _img_b, {"data_range": 1.0}, id="ssim"),
]


@pytest.mark.parametrize("fn, preds, target, kwargs", _GRAD_CASES)
def test_gradient_matches_jax_grad(fn, preds, target, kwargs):
    x = torch.tensor(preds, dtype=torch.float64, requires_grad=True)
    out = getattr(TF, fn)(x, _t(target), **kwargs)
    if out.requires_grad:
        (grad,) = torch.autograd.grad(out.sum(), x)
    else:  # ranks carry no gradient: the JAX package's is zero everywhere
        grad = torch.zeros_like(x)
    want = jax.grad(lambda p: jnp.sum(getattr(JF, fn)(p, jnp.asarray(target), **kwargs)))(jnp.asarray(preds))
    assert grad.dtype == torch.float64
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), **F64)
    module = {"mean_squared_error": T.MeanSquaredError, "spearman_corrcoef": T.SpearmanCorrcoef}.get(fn)
    if module is not None:
        assert module.is_differentiable == bool(np.any(np.asarray(want) != 0))


# -- exports and the compiled step's gate -----------------------------------------------------


def test_regression_names_are_exported_as_the_jax_package_exports_them():
    for name in ("CosineSimilarity", "ExplainedVariance", "MeanAbsoluteError", "MeanAbsolutePercentageError",
                 "MeanSquaredError", "MeanSquaredLogError", "PearsonCorrcoef", "R2Score", "SpearmanCorrcoef",
                 "PSNR", "SSIM"):
        assert hasattr(J, name) and hasattr(T, name), name
    for name in ("cosine_similarity", "explained_variance", "mean_absolute_error", "mean_absolute_percentage_error",
                 "mean_relative_error", "mean_squared_error", "mean_squared_log_error", "pearson_corrcoef", "psnr",
                 "r2score", "spearman_corrcoef", "ssim"):
        assert hasattr(JF, name) and hasattr(TF, name), name
    import metrics_tpu.regression as JR
    import metrics_tpu_torch.regression as TR

    assert sorted(n for n in dir(JR) if n[0].isupper()) == sorted(n for n in dir(TR) if n[0].isupper())


@pytest.mark.parametrize(
    "make",
    [
        lambda pkg, **d: pkg.PearsonCorrcoef(**d),
        lambda pkg, **d: pkg.CosineSimilarity(**d),
        lambda pkg, **d: pkg.SpearmanCorrcoef(**d),
    ],
)
def test_list_modes_refuse_the_compiled_step_with_the_jax_error(make):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port, ref = make(T, **CPU), make(J)
    with pytest.raises(ValueError) as port_err:
        port.jit_forward()
    with pytest.raises(ValueError) as jax_err:
        ref.jit_forward()
    assert str(port_err.value).split(";")[0] == str(jax_err.value).split(";")[0]


# -- the compiled step of the fixed-state members ------------------------------------------


def _fixed_members(pkg, **device):
    return {
        "mse": pkg.MeanSquaredError(**device),
        "rmse": pkg.MeanSquaredError(squared=False, **device),
        "mae": pkg.MeanAbsoluteError(**device),
        "mape": pkg.MeanAbsolutePercentageError(**device),
        "msle": pkg.MeanSquaredLogError(**device),
        "ev": pkg.ExplainedVariance(**device),
        "r2": pkg.R2Score(**device),
        "pearson": pkg.PearsonCorrcoef(streaming=True, **device),
        "spearman_cap": pkg.SpearmanCorrcoef(capacity=512, **device),
        "spearman_grid": pkg.SpearmanCorrcoef(sketched=True, num_bins=64, value_range=(0.0, 4.0), **device),
    }


def _lognormal_batches(seed, k=6, n=64):
    rng = np.random.RandomState(seed)
    target = np.exp(rng.randn(k, n) * 0.5).astype(np.float32)
    preds = np.clip(target * (1 + 0.1 * rng.randn(k, n)), 0, None).astype(np.float32)
    return preds, target


def test_fixed_state_members_run_the_compiled_step_without_host_reads():
    """The fixed-state regression members (and streaming cosine) under
    ``jit_forward``: every on-step value and the epoch value equal the eager
    forward's, one program per signature, no value read to the host inside
    it; ``update_many`` equals K eager updates; the epoch values hold
    against the JAX package's."""
    from tests.test_torch_jit_forward import no_host_reads

    preds, target = _lognormal_batches(71)
    eager = T.MetricCollection(_fixed_members(T, **CPU))
    compiled = T.MetricCollection(_fixed_members(T, **CPU)).jit_forward()
    ref = J.MetricCollection(_fixed_members(J))
    cos_eager = T.CosineSimilarity(reduction="mean", streaming=True, **CPU)
    cos_compiled = T.CosineSimilarity(reduction="mean", streaming=True, **CPU).jit_forward()
    vectors = np.random.RandomState(72).randn(6, 16, 8).astype(np.float32)
    with no_host_reads():
        for i in range(len(preds)):
            want = eager(_t(preds[i]), _t(target[i]))
            got = compiled(_t(preds[i]), _t(target[i]))
            ref(jnp.asarray(preds[i]), jnp.asarray(target[i]))
            for name in want:
                torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, equal_nan=True)
            torch.testing.assert_close(cos_compiled(_t(vectors[i]), _t(vectors[i][::-1].copy())),
                                       cos_eager(_t(vectors[i]), _t(vectors[i][::-1].copy())), rtol=0, atol=0)
    got, want, jax_out = compiled.compute(), eager.compute(), ref.compute()
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
        _close(got[name], jax_out[name])
    torch.testing.assert_close(cos_compiled.compute(), cos_eager.compute(), rtol=0, atol=0)

    many = T.MetricCollection(_fixed_members(T, **CPU))
    with no_host_reads():
        many.update_many(_t(preds), _t(target))
    once = T.MetricCollection(_fixed_members(T, **CPU))
    for i in range(len(preds)):
        once.update(_t(preds[i]), _t(target[i]))
    for name, m in many.items(keep_base=True):
        for leaf, value in m._get_states().items():
            torch.testing.assert_close(value, getattr(once[name], leaf), rtol=0, atol=0, msg=f"{name}.{leaf}")


def test_keyed_regression_update_is_compiled_without_host_reads():
    from tests.test_torch_jit_forward import no_host_reads

    def build():
        return T.MultiTenantCollection([T.MeanSquaredError(**CPU), T.MeanAbsoluteError(**CPU),
                                        T.PearsonCorrcoef(streaming=True, **CPU)], 16, validate_ids=False, **CPU)

    rng = np.random.RandomState(73)
    ids = rng.randint(-1, 16, (5, 40))
    preds, target = rng.rand(5, 40).astype(np.float32), rng.rand(5, 40).astype(np.float32)
    eager, compiled, many = build(), build(), build()
    compiled.warmup(_t(ids[0]), _t(preds[0]), _t(target[0]))
    with no_host_reads():
        for k in range(5):
            eager.update(_t(ids[k]), _t(preds[k]), _t(target[k]))
            compiled.update(_t(ids[k]), _t(preds[k]), _t(target[k]))
        many.update_many(_t(ids), _t(preds), _t(target))
    for other in (compiled, many):
        for owner, km in eager._keyed.items():
            for name, value in km._get_states().items():
                torch.testing.assert_close(getattr(other._keyed[owner], name), value, rtol=0, atol=0)


def test_capacity_forward_keeps_one_buffer_where_the_jax_package_adds_a_shard():
    """``SpearmanCorrcoef(capacity=8)``, three forwards of 4 pairs: the JAX
    package's fused forward concatenates its ``"cat"`` buffer leaves (four
    shards, 12 pairs counted, no drop); the port's forward updates the one
    buffer in place (the double-update protocol), keeps the first 8 pairs
    and warns that 4 were dropped. Each batch's on-step value is the same."""
    rng = np.random.RandomState(74)
    port, ref = T.SpearmanCorrcoef(capacity=8, **CPU), J.SpearmanCorrcoef(capacity=8)
    batches = [rng.rand(4) for _ in range(3)]
    for p in batches:
        _close(port(_t(p), _t(p * p)), ref(jnp.asarray(p), jnp.asarray(p * p)))
    assert ref.buf.shape == (4 * 16 * 2,) and np.asarray(ref.count).tolist() == [0, 4, 4, 4]
    assert tuple(port.buf.shape) == (16 * 2,) and int(port.count) == 12
    with pytest.warns(UserWarning, match="dropped 4"):
        value = port.compute()
    flat = np.concatenate(batches)[:8]
    np.testing.assert_allclose(float(value), spearmanr(flat, flat * flat).statistic, atol=1e-6)
