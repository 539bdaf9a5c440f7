"""The port's retrieval family against the JAX package's.

Mirrors ``tests/retrieval/test_retrieval.py`` and
``tests/retrieval/test_padded_mode.py`` case by case: the same seeded numpy
inputs (``tests/retrieval/inputs.py``'s fixtures and
``np.random.RandomState``) go through the ``metrics_tpu`` object and its
``metrics_tpu_torch`` counterpart (``device="cpu"``). The flat (``indexes``),
padded (``padded=True``), sketched (``sketched=True``) and keyed padded
modes are each held against the JAX object; the ``ddp=True`` cases stripe the
batches over two ranks simulated by threads
(``tests/test_torch_distributed.py::_run_ranks``) and compare the synced
``compute()`` with the JAX package's ``sharded_compute`` of the same stripes.

Tolerance: float32 rounding, ``atol=1e-6`` (the JAX tests' own), since both
packages score in float32 and sum in different orders; the padded
``value_sum`` is float32 in the port where the JAX package keeps float64
under x64 (ROADMAP, queue C). Dtypes are asserted apart from the values.
The reservoir's states and the query counts are held exactly.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as JF
import metrics_tpu_torch as T
import metrics_tpu_torch.functional as TF
from metrics_tpu.retrieval.retrieval_metric import RetrievalMetric as JRetrievalMetric
from metrics_tpu_torch.kernels import _common
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from tests.helpers.testers import NUM_BATCHES, sharded_compute
from tests.retrieval.inputs import _irs, _irs_empty_queries, _irs_non_binary
from tests.test_torch_distributed import _run_ranks
from tests.test_torch_jit_forward import no_host_reads

CPU = {"device": "cpu"}
ATOL = dict(rtol=0, atol=1e-6)
_RES = ("res_key", "res_qid", "res_pred", "res_target", "res_seen", "res_overflow")

# (class, functional, empty on, takes k): the JAX test's table, with nDCG
_METRICS = [
    ("RetrievalMAP", "retrieval_average_precision", "pos", False),
    ("RetrievalMRR", "retrieval_reciprocal_rank", "pos", False),
    ("RetrievalPrecision", "retrieval_precision", "pos", True),
    ("RetrievalRecall", "retrieval_recall", "pos", True),
    ("RetrievalFallOut", "retrieval_fall_out", "neg", True),
    ("RetrievalNormalizedDCG", "retrieval_normalized_dcg", "pos", True),
]
_CLASSES = [m[0] for m in _METRICS]


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


def _close(got, want):
    """The port's float32 value against the JAX package's, at float32 rounding."""
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32, got
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64), **ATOL)


def _pair(name, **kwargs):
    return getattr(J, name)(**kwargs), getattr(T, name)(**kwargs, **CPU)


def _feed(metric, pkg, preds, target, indexes=None, mask=None, forward=False):
    conv = _j if pkg == "jax" else _t
    kw = {}
    if indexes is not None:
        kw["indexes"] = conv(indexes)
    if mask is not None:
        kw["mask"] = conv(mask)
    return (metric if forward else metric.update)(conv(preds), conv(target), **kw)


def _synced_compute(m):
    with m.sync_context(distributed_available=lambda: True):
        return m.compute()


# -- the functionals on single queries ------------------------------------------------------


@pytest.mark.parametrize("name, fn, empty_on, has_k", _METRICS)
def test_functional_single_query(name, fn, empty_on, has_k):
    rng = np.random.RandomState(7)
    for n in (1, 5, 33):
        preds = rng.rand(n).astype(np.float32)
        target = rng.randint(0, 2 if fn != "retrieval_normalized_dcg" else 4, size=n)
        for k in ([None, 1, 3] if has_k else [None]):
            if k is not None and k > n:
                continue
            kwargs = {} if k is None else {"k": k}
            got = getattr(TF, fn)(_t(preds), _t(target), **kwargs)
            want = getattr(JF, fn)(_j(preds), _j(target), **kwargs)
            assert got.shape == ()
            _close(got, want)


@pytest.mark.parametrize("name, fn, empty_on, has_k", _METRICS)
def test_functional_empty_and_full_queries(name, fn, empty_on, has_k):
    """A query with no positive (no negative for fall-out) scores 0."""
    preds = np.array([0.3, 0.1, 0.7, 0.5], np.float32)
    for target in (np.zeros(4, np.int64), np.ones(4, np.int64), np.array([True, False, False, True])):
        got = getattr(TF, fn)(_t(preds), _t(target))
        _close(got, getattr(JF, fn)(_j(preds), _j(target)))


def test_functional_ndcg_non_binary_and_float_graded_relevance():
    rng = np.random.RandomState(3)
    preds = rng.rand(40).astype(np.float32)
    for target in (rng.randint(0, 5, size=40), (rng.rand(40) * 4).astype(np.float32)):
        for k in (None, 1, 7, 40):
            got = TF.retrieval_normalized_dcg(_t(preds), _t(target), k=k)
            _close(got, JF.retrieval_normalized_dcg(_j(preds), _j(target), k=k))


@pytest.mark.parametrize(
    "fn, preds, target, match",
    [
        ("retrieval_precision", [0.1, 0.2], [1], "same shape"),
        ("retrieval_precision", np.float32(0.1), np.int64(1), "non-scalar"),
        ("retrieval_recall", [0.1, 0.2], [0.0, 1.0], "booleans or integers"),
        ("retrieval_average_precision", [1, 2], [0, 1], "floats"),
        ("retrieval_reciprocal_rank", [0.1, 0.2], [0, 2], "binary"),
        ("retrieval_fall_out", [0.1, 0.2], [0, -1], "binary"),
        ("retrieval_normalized_dcg", [0.1, 0.2], [0, -1], "binary"),
    ],
)
def test_functional_input_errors_match_the_jax_package(fn, preds, target, match):
    preds, target = np.asarray(preds), np.asarray(target)
    with pytest.raises(ValueError, match=match) as port_err:
        getattr(TF, fn)(_t(preds), _t(target))
    with pytest.raises(ValueError) as jax_err:
        getattr(JF, fn)(_j(preds), _j(target))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("k", [0, -1, 1.5, "2"])
def test_functional_bad_k(k):
    with pytest.raises(ValueError, match="positive integer"):
        TF.retrieval_precision(_t(np.array([0.1, 0.2], np.float32)), _t(np.array([0, 1])), k=k)


# -- the flat mode ----------------------------------------------------------------------------


def _run_flat(name, inputs, args, ddp):
    """``forward`` per batch (each batch value held) and ``compute``, or two
    ranks' synced compute, of the JAX and the port metric."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if not ddp:
            jm, tm = _pair(name, **args)
            for i in range(NUM_BATCHES):
                got = _feed(tm, "torch", inputs.preds[i], inputs.target[i], inputs.indexes[i], forward=True)
                _close(got, _feed(jm, "jax", inputs.preds[i], inputs.target[i], inputs.indexes[i], forward=True))
            return tm.compute(), jm.compute()
        ranks = [getattr(J, name)(**args) for _ in range(2)]
        for i in range(NUM_BATCHES):
            _feed(ranks[i % 2], "jax", inputs.preds[i], inputs.target[i], inputs.indexes[i])
        want = sharded_compute(ranks[0], ranks)

        def rank(r):
            def run():
                m = getattr(T, name)(**args, **CPU)
                for i in range(r, NUM_BATCHES, 2):
                    _feed(m, "torch", inputs.preds[i], inputs.target[i], inputs.indexes[i])
                return _synced_compute(m)

            return run

        results, errors, calls = _run_ranks([rank(0), rank(1)], "torch")
        assert errors == [None, None]
        assert calls[0] == calls[1] > 0
        torch.testing.assert_close(results[0], results[1], rtol=0, atol=0)
        return results[0], want


@pytest.mark.parametrize("name", _CLASSES[:5])
@pytest.mark.parametrize("ddp", [False, True])
def test_class_metric(name, ddp):
    _close(*_run_flat(name, _irs, {}, ddp))


@pytest.mark.parametrize("k", [None, 1, 4])
@pytest.mark.parametrize("ddp", [False, True])
def test_ndcg_class(k, ddp):
    _close(*_run_flat("RetrievalNormalizedDCG", _irs_non_binary, {"k": k}, ddp))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut"])
def test_k_variants(name, k):
    _close(*_run_flat(name, _irs, {"k": k}, False))


@pytest.mark.parametrize("name", _CLASSES)
@pytest.mark.parametrize("empty_target_action", ["neg", "pos", "skip"])
def test_empty_target_policies(name, empty_target_action):
    jm, tm = _pair(name, empty_target_action=empty_target_action)
    for i in range(NUM_BATCHES):
        for m, pkg in ((jm, "jax"), (tm, "torch")):
            _feed(m, pkg, _irs_empty_queries.preds[i], _irs_empty_queries.target[i], _irs_empty_queries.indexes[i])
    _close(tm.compute(), jm.compute())


@pytest.mark.parametrize("name", _CLASSES)
def test_empty_target_error(name):
    jm, tm = _pair(name, empty_target_action="error")
    for m, pkg in ((jm, "jax"), (tm, "torch")):
        _feed(m, pkg, _irs_empty_queries.preds[0], _irs_empty_queries.target[0], _irs_empty_queries.indexes[0])
    with pytest.raises(ValueError, match="no (positive|negative) target") as port_err:
        tm.compute()
    with pytest.raises(ValueError) as jax_err:
        jm.compute()
    assert str(port_err.value) == str(jax_err.value)
    # no query is empty in the first batch of the plain fixture: the mean
    jm, tm = _pair(name, empty_target_action="error")
    preds, target, idx = np.array([0.2, 0.9, 0.4, 0.3], np.float32), np.array([1, 0, 0, 1]), np.array([0, 0, 1, 1])
    for m, pkg in ((jm, "jax"), (tm, "torch")):
        _feed(m, pkg, preds, target, idx)
    _close(tm.compute(), jm.compute())


def test_ndcg_float_graded_relevance_module():
    rng = np.random.RandomState(4)
    preds = rng.rand(40).astype(np.float32)
    target = (rng.rand(40) * 4).astype(np.float32)
    jm, tm = _pair("RetrievalNormalizedDCG")
    for m, pkg in ((jm, "jax"), (tm, "torch")):
        _feed(m, pkg, preds, target, np.zeros(40, np.int64))
    assert tm.target[0].dtype == torch.float32
    _close(tm.compute(), jm.compute())


@pytest.mark.parametrize(
    "indexes, preds, target, match",
    [
        (None, [0.1], [1], "cannot be None"),
        ([0], [0.1], [1.0], "booleans or integers"),
        ([0.5], [0.1], [1], "long integers"),
        ([0, 0], [0.1, 0.2], [0, 3], "binary"),
        ([0], [1], [1], "floats"),
        ([0, 1], [0.1], [1], "same shape"),
        ([True], [0.1], [1], "long integers"),
    ],
)
def test_update_input_errors(indexes, preds, target, match):
    jm, tm = _pair("RetrievalMAP")
    idx = None if indexes is None else np.asarray(indexes)
    with pytest.raises(ValueError, match=match) as port_err:
        _feed(tm, "torch", np.asarray(preds), np.asarray(target), idx)
    with pytest.raises(ValueError) as jax_err:
        _feed(jm, "jax", np.asarray(preds), np.asarray(target), idx)
    assert str(port_err.value) == str(jax_err.value)


def test_constructor_gates_match_the_jax_package():
    cases = [
        (dict(empty_target_action="bogus"), ValueError, "received a wrong value"),
        (dict(sketched=True, padded=True), ValueError, "padded"),
        (dict(padded=True, empty_target_action="error"), ValueError, "padded"),
        (dict(sketched=True, sketch_capacity=0), ValueError, "sketch_capacity"),
        (dict(k=3), TypeError, "does not accept `k`"),
    ]
    for name in ("RetrievalMAP", "RetrievalMRR"):
        for kwargs, err, match in cases:
            with pytest.raises(err, match=match) as port_err:
                getattr(T, name)(**kwargs, **CPU)
            with pytest.raises(err) as jax_err:
                getattr(J, name)(**kwargs)
            assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="positive integer"):
        T.RetrievalPrecision(k=0, **CPU)
    with pytest.raises(TypeError):
        T.RetrievalFallOut(sketched=True, **CPU)


@pytest.mark.parametrize("name", _CLASSES)
def test_flat_and_sketched_modes_refuse_the_compiled_step_and_keying_naming_the_sketch(name):
    modes = [{}] if name == "RetrievalFallOut" else [{}, {"sketched": True, "sketch_capacity": 64}]
    for kwargs in modes:
        port = getattr(T, name)(**kwargs, **CPU)
        ref = getattr(J, name)(**kwargs)
        if not kwargs:
            with pytest.raises(ValueError, match="sketched=True"):
                port.jit_forward()
            with pytest.raises(ValueError, match="sketched=True"):
                ref.jit_forward()
        for m in (port, ref):
            with pytest.raises(ValueError, match="sketched=True"):
                m.keyed(4)


def test_retrieval_names_are_exported_as_the_jax_package_exports_them():
    import metrics_tpu.functional.retrieval as JFR
    import metrics_tpu.retrieval as JR
    import metrics_tpu_torch.functional.retrieval as TFR
    import metrics_tpu_torch.retrieval as TR

    assert sorted(JR.__all__) == sorted(TR.__all__)
    assert sorted(JFR.__all__) == sorted(TFR.__all__)
    for name in JR.__all__:
        assert getattr(T, name) is getattr(TR, name)
    for name in JFR.__all__:
        assert getattr(TF, name) is getattr(TFR, name)


# -- ties, signed zeros and NaN scores ---------------------------------------------------------


def _awkward_stream(seed, n=400, queries=12):
    """Scores on a coarse grid (exact ties), with +0.0, -0.0, NaN, +-inf."""
    rng = np.random.RandomState(seed)
    preds = np.round(rng.rand(n) * 4) / 4
    special = rng.rand(n)
    preds[special < 0.15] = 0.0
    preds[(special >= 0.15) & (special < 0.3)] = -0.0
    preds[(special >= 0.3) & (special < 0.36)] = np.nan
    preds[(special >= 0.36) & (special < 0.4)] = np.inf
    preds[(special >= 0.4) & (special < 0.44)] = -np.inf
    return rng.randint(0, queries, n), preds.astype(np.float32), rng.randint(0, 2, n)


@pytest.mark.parametrize("seed", range(4))
def test_grouping_keeps_arrival_order_for_ties_signed_zeros_and_nan(seed):
    """The flat mode's layout equals numpy's ``lexsort((-preds, inverse))``
    (the JAX package's host pass): ties and the two zeros in arrival order,
    NaN scores last in their query."""
    idx, preds, target = _awkward_stream(seed)
    marks = np.arange(idx.size)  # carry each row's position through the layout
    rows, lengths = RetrievalMetric._group_arrays_into_rows(_t(idx).to(torch.int32), _t(preds), _t(marks))
    _, inverse = np.unique(idx, return_inverse=True)
    order = np.lexsort((-preds, inverse))
    counts = np.bincount(inverse)
    want = np.zeros((counts.size, counts.max()), np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    want[inverse[order], np.arange(idx.size) - starts[inverse[order]]] = marks[order]
    np.testing.assert_array_equal(rows.numpy(), want)
    np.testing.assert_array_equal(lengths.numpy(), counts)
    jrows, jlengths = JRetrievalMetric._group_arrays_into_rows(idx.astype(np.int32), preds, marks)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))


@pytest.mark.parametrize("name", _CLASSES)
@pytest.mark.parametrize("seed", range(3))
def test_ties_signed_zeros_and_nan_scores_match_the_jax_package(name, seed):
    idx, preds, target = _awkward_stream(seed)
    kwargs = {"k": 5} if name not in ("RetrievalMAP", "RetrievalMRR") else {}
    jm, tm = _pair(name, **kwargs)
    for m, pkg in ((jm, "jax"), (tm, "torch")):
        _feed(m, pkg, preds, target, idx)
    _close(tm.compute(), jm.compute())
    # the functional of each query alone
    fn = dict((m[0], m[1]) for m in _METRICS)[name]
    for q in np.unique(idx)[:4]:
        sel = idx == q
        _close(getattr(TF, fn)(_t(preds[sel]), _t(target[sel]), **kwargs),
               getattr(JF, fn)(_j(preds[sel]), _j(target[sel]), **kwargs))
    # the padded mode, one query a row
    rows = [np.flatnonzero(idx == q) for q in np.unique(idx)]
    width = max(len(r) for r in rows)
    p = np.zeros((len(rows), width), np.float32)
    t = np.zeros((len(rows), width), np.int64)
    mask = np.zeros((len(rows), width), bool)
    for i, r in enumerate(rows):
        p[i, :len(r)], t[i, :len(r)], mask[i, :len(r)] = preds[r], target[r], True
    p[~mask] = np.nan  # garbage in the padding must not matter
    jp, tp = _pair(name, padded=True, **kwargs)
    _feed(jp, "jax", p, t, mask=mask)
    _feed(tp, "torch", p, t, mask=mask)
    _close(tp.compute(), jp.compute())
    _close(tp.compute(), tm.compute())


# -- the padded mode ----------------------------------------------------------------------------


def _to_flat(preds, target, mask):
    q, d = preds.shape
    idx = np.repeat(np.arange(q), d)
    keep = mask.reshape(-1)
    return idx[keep], preds.reshape(-1)[keep], target.reshape(-1)[keep]


@pytest.mark.parametrize("name", _CLASSES)
@pytest.mark.parametrize("ragged", [False, True])
def test_padded_matches_flat_stream_and_the_jax_package(name, ragged):
    rng = np.random.RandomState(23)
    q, d = 12, 10
    preds = rng.rand(q, d).astype(np.float32)
    target = rng.randint(0, 2, (q, d))
    mask = np.arange(d)[None, :] < rng.randint(2, d + 1, q)[:, None] if ragged else np.ones((q, d), bool)
    jp, tp = _pair(name, padded=True)
    got = _feed(tp, "torch", preds, target, mask=mask, forward=True)
    _close(got, _feed(jp, "jax", preds, target, mask=mask, forward=True))
    flat = getattr(T, name)(**CPU)
    _feed(flat, "torch", *_to_flat(preds, target, mask)[1:], _to_flat(preds, target, mask)[0])
    _close(tp.compute(), jp.compute())
    _close(tp.compute(), flat.compute().numpy())
    assert tp.value_sum.dtype == torch.float32 and tp.query_total.dtype == torch.int32
    assert int(tp.query_total) == int(jp.query_total)
    np.testing.assert_allclose(float(tp.value_sum), float(jp.value_sum), rtol=1e-6)


@pytest.mark.parametrize("name", _CLASSES)
@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
def test_padded_empty_policies_match(name, action):
    rng = np.random.RandomState(24)
    q, d = 8, 6
    preds = rng.rand(q, d).astype(np.float32)
    target = rng.randint(0, 2, (q, d))
    target[0] = 0
    target[1] = 1
    mask = np.ones((q, d), bool)
    jp, tp = _pair(name, padded=True, empty_target_action=action)
    _feed(jp, "jax", preds, target, mask=mask)
    _feed(tp, "torch", preds, target, mask=mask)
    _close(tp.compute(), jp.compute())
    assert int(tp.query_total) == int(jp.query_total)


def test_padded_query_axis_padding_dropped():
    rng = np.random.RandomState(25)
    preds = rng.rand(4, 5).astype(np.float32)
    target = rng.randint(0, 2, (4, 5))
    target[:, 0] = 1
    mask = np.ones((4, 5), bool)
    mask[2:] = False
    jp, tp = _pair("RetrievalMRR", padded=True)
    _feed(jp, "jax", preds, target, mask=mask)
    _feed(tp, "torch", preds, target, mask=mask)
    assert int(tp.query_total) == int(jp.query_total) == 2
    _close(tp.compute(), jp.compute())


def test_padded_rejects_error_action_and_bad_inputs():
    tp, jp = T.RetrievalMAP(padded=True, **CPU), J.RetrievalMAP(padded=True)
    bad = [
        ((np.array([0.1, 0.2], np.float32), np.array([0, 1])), {}, "expects"),
        ((np.ones((4, 5), np.float32), np.zeros((4, 5), np.int64)), {"mask": np.ones((4, 1), bool)}, "mask"),
        ((np.ones((4, 5), np.int64), np.zeros((4, 5), np.int64)), {}, "floats"),
        ((np.ones((4, 5), np.float32), np.full((4, 5), 2)), {}, "binary"),
        ((np.ones((4, 5), np.float32), np.full((4, 5), 0.5, np.float32)), {}, "binary"),
    ]
    for (preds, target), kw, match in bad:
        with pytest.raises(ValueError, match=match):
            _feed(tp, "torch", preds, target, **kw)
        with pytest.raises(ValueError, match=match):
            _feed(jp, "jax", preds, target, **kw)
    # a value outside {0, 1} in the masked-off padding is no error
    target = np.full((2, 3), 7)
    target[:, 0] = 1
    mask = np.zeros((2, 3), bool)
    mask[:, 0] = True
    _feed(tp, "torch", np.ones((2, 3), np.float32), target, mask=mask)
    _feed(jp, "jax", np.ones((2, 3), np.float32), target, mask=mask)
    _close(tp.compute(), jp.compute())


def test_padded_real_neg_inf_score_beats_padding():
    tp = T.RetrievalMRR(padded=True, **CPU)
    _feed(tp, "torch", np.array([[0.3, -np.inf]], np.float32), np.array([[0, 1]]), mask=np.array([[True, True]]))
    np.testing.assert_allclose(float(tp.compute()), 0.5, atol=1e-6)
    tp2 = T.RetrievalMRR(padded=True, **CPU)
    _feed(tp2, "torch", np.array([[-np.inf, 123.0]], np.float32), np.array([[1, 1]]), mask=np.array([[True, False]]))
    np.testing.assert_allclose(float(tp2.compute()), 1.0, atol=1e-6)


def test_padded_fused_forward_single_pass():
    tp = T.RetrievalMRR(padded=True, **CPU)
    preds, target = np.array([[0.9, 0.1], [0.2, 0.8]], np.float32), np.array([[1, 0], [1, 0]])
    step = _feed(tp, "torch", preds, target, forward=True)
    np.testing.assert_allclose(float(step), 0.75, atol=1e-6)
    assert tp._states_mergeable() and int(tp.query_total) == 2
    _feed(tp, "torch", preds, target, forward=True)
    assert int(tp.query_total) == 4


@pytest.mark.parametrize("name", _CLASSES)
def test_padded_compiled_step_and_update_many_read_nothing_to_the_host(name):
    """``jit_forward`` + ``warmup`` and ``update_many`` of the padded mode:
    every on-step value and the states equal the eager forward's, no value
    read to the host inside the program; the epoch value equals the JAX
    package's."""
    rng = np.random.RandomState(26)
    k, q, d = 5, 6, 8
    preds = rng.rand(k, q, d).astype(np.float32)
    target = rng.randint(0, 2, (k, q, d))
    mask = np.arange(d)[None, None, :] < rng.randint(0, d + 1, (k, q))[..., None]
    eager = getattr(T, name)(padded=True, **CPU)
    compiled = getattr(T, name)(padded=True, **CPU).jit_forward()
    ref = getattr(J, name)(padded=True)
    compiled.warmup(_t(preds[0]), _t(target[0]), mask=_t(mask[0]))
    with no_host_reads():
        for i in range(k):
            want = _feed(eager, "torch", preds[i], target[i], mask=mask[i], forward=True)
            got = _feed(compiled, "torch", preds[i], target[i], mask=mask[i], forward=True)
            _feed(ref, "jax", preds[i], target[i], mask=mask[i])
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    for leaf in ("value_sum", "query_total"):
        torch.testing.assert_close(getattr(compiled, leaf), getattr(eager, leaf), rtol=0, atol=0)
    _close(compiled.compute(), ref.compute())
    many = getattr(T, name)(padded=True, **CPU)
    with no_host_reads():
        many.update_many(_t(preds), _t(target), mask=_t(mask))
    torch.testing.assert_close(many.query_total, eager.query_total, rtol=0, atol=0)
    torch.testing.assert_close(many.value_sum, eager.value_sum, rtol=1e-6, atol=1e-6)


def test_padded_collection_matches_the_jax_collection():
    rng = np.random.RandomState(27)

    def members(pkg, **device):
        return {n: getattr(pkg, n)(padded=True, **({"k": 3} if n not in ("RetrievalMAP", "RetrievalMRR") else {}),
                                    **device) for n in _CLASSES}

    tc, jc = T.MetricCollection(members(T, **CPU)), J.MetricCollection(members(J))
    for _ in range(4):
        preds, target = rng.rand(10, 7).astype(np.float32), rng.randint(0, 2, (10, 7))
        got, want = tc(_t(preds), _t(target)), jc(_j(preds), _j(target))
        for n in want:
            _close(got[n], want[n])
    got, want = tc.compute(), jc.compute()
    for n in want:
        _close(got[n], want[n])


# -- the sketched mode -----------------------------------------------------------------------


def _assert_reservoir_equal(port, ref):
    for name in _RES:
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        assert got.dtype == port._defaults[name].dtype, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("cap", [4096, 512, 64])
def test_sketched_reservoir_states_equal_the_jax_states_exactly(cap):
    rng = np.random.RandomState(13)
    queries, preds, target = rng.randint(0, 200, 3000), rng.rand(3000).astype(np.float32), rng.randint(0, 2, 3000)
    jm, tm = _pair("RetrievalMAP", sketched=True, sketch_capacity=cap)
    exact = T.RetrievalMAP(**CPU)
    for i in range(6):
        sl = slice(i * 500, (i + 1) * 500)
        for m, pkg in ((jm, "jax"), (tm, "torch")):
            _feed(m, pkg, preds[sl], target[sl], queries[sl])
        _feed(exact, "torch", preds[sl], target[sl], queries[sl])
        _assert_reservoir_equal(tm, jm)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = tm.compute()
        want = jm.compute()
    sampled = [w for w in seen if "sampled the query stream" in str(w.message)]
    if cap == 4096:
        assert not sampled
        assert float(got) == float(exact.compute())  # never overflowed: the exact flat value
    else:
        assert len(sampled) == 2 and str(sampled[0].message) == str(sampled[1].message)
    _close(got, want)


@pytest.mark.parametrize("name", ["RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalNormalizedDCG"])
def test_sketched_members_match_the_jax_package(name):
    rng = np.random.RandomState(14)
    queries, preds = rng.randint(0, 300, 4000), rng.rand(4000).astype(np.float32)
    target = rng.randint(0, 3 if name == "RetrievalNormalizedDCG" else 2, 4000)
    kwargs = {"k": 4} if name != "RetrievalMRR" else {}
    jm, tm = _pair(name, sketched=True, sketch_capacity=700, **kwargs)
    for i in range(4):
        sl = slice(i * 1000, (i + 1) * 1000)
        for m, pkg in ((jm, "jax"), (tm, "torch")):
            _feed(m, pkg, preds[sl], target[sl], queries[sl])
    _assert_reservoir_equal(tm, jm)
    with pytest.warns(UserWarning, match="sampled"):
        got = tm.compute()
    with pytest.warns(UserWarning, match="sampled"):
        _close(got, jm.compute())


def test_sketched_estimate_converges_with_capacity():
    rng = np.random.RandomState(14)
    queries, preds, target = rng.randint(0, 500, 10_000), rng.rand(10_000).astype(np.float32), rng.randint(0, 2, 10_000)
    exact = T.RetrievalMAP(**CPU)
    _feed(exact, "torch", preds, target, queries)
    ref = float(exact.compute())
    errs = []
    for cap in (512, 4096):
        m = T.RetrievalMAP(sketched=True, sketch_capacity=cap, **CPU)
        _feed(m, "torch", preds, target, queries)
        with pytest.warns(UserWarning, match="sampled"):
            errs.append(abs(float(m.compute()) - ref))
    assert errs[1] < max(errs[0], 0.05) + 1e-9


def test_sketched_forward_is_the_double_update_and_matches_the_jax_package():
    rng = np.random.RandomState(15)
    jm, tm = _pair("RetrievalMAP", sketched=True, sketch_capacity=256)
    for _ in range(3):
        q, p, t = rng.randint(0, 40, 100), rng.rand(100).astype(np.float32), rng.randint(0, 2, 100)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = _feed(tm, "torch", p, t, q, forward=True)
            _close(got, _feed(jm, "jax", p, t, q, forward=True))
    _assert_reservoir_equal(tm, jm)


def test_sketched_update_is_compiled_without_host_reads():
    """``RetrievalMAP(sketched=True, compute_on_step=False).jit_forward()``
    (``tests/kernels/test_sketches.py:412-426``) and ``update_many``: the
    reservoir equals the eager run's and the JAX package's exactly."""
    rng = np.random.RandomState(5)
    compiled = T.RetrievalMAP(sketched=True, sketch_capacity=128, compute_on_step=False, **CPU).jit_forward()
    eager, ref = T.RetrievalMAP(sketched=True, sketch_capacity=128, **CPU), J.RetrievalMAP(sketched=True,
                                                                                          sketch_capacity=128)
    stacks = [rng.randint(0, 40, (3, 100)), rng.rand(3, 100).astype(np.float32), rng.randint(0, 2, (3, 100))]
    with no_host_reads():
        for i in range(3):
            compiled(_t(stacks[1][i]), _t(stacks[2][i]), indexes=_t(stacks[0][i]))
    for i in range(3):
        _feed(eager, "torch", stacks[1][i], stacks[2][i], stacks[0][i])
        _feed(ref, "jax", stacks[1][i], stacks[2][i], stacks[0][i])
    _assert_reservoir_equal(compiled, ref)
    _assert_reservoir_equal(eager, ref)
    many = T.RetrievalMAP(sketched=True, sketch_capacity=128, **CPU)
    with no_host_reads():
        many.update_many(_t(stacks[1]), _t(stacks[2]), indexes=_t(stacks[0]))
    _assert_reservoir_equal(many, ref)
    with pytest.warns(UserWarning, match="sampled"):
        got = compiled.compute()
    with pytest.warns(UserWarning, match="sampled"):
        assert float(got) == float(eager.compute())
    with pytest.warns(UserWarning, match="sampled"):
        _close(got, ref.compute())
    with pytest.raises(NotImplementedError, match="concrete"):
        T.RetrievalMAP(sketched=True, sketch_capacity=128, **CPU).jit_forward()(
            _t(stacks[1][0]), _t(stacks[2][0]), indexes=_t(stacks[0][0]))


# -- two ranks ------------------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [1024, 96])
def test_sketched_ddp_merges_the_reservoirs_by_the_cat_gather(cap):
    """Two ranks' reservoirs gathered by the port's sync equal the JAX
    package's merge of the same two reservoirs (``"cat"`` slices, counted
    as one cross-shard sketch merge), and below capacity the single-process
    value (``tests/kernels/test_sketches.py:502-527``)."""
    rng = np.random.RandomState(16)
    q, p, t = rng.randint(0, 60, 800), rng.rand(800).astype(np.float32), rng.randint(0, 2, 800)
    shards = []
    for i in range(2):
        m = J.RetrievalMAP(sketched=True, sketch_capacity=cap)
        sl = slice(i * 400, (i + 1) * 400)
        _feed(m, "jax", p[sl], t[sl], q[sl])
        shards.append(m)
    merged = J.RetrievalMAP(sketched=True, sketch_capacity=cap)
    merged._update_called = True
    for name in ("res_key", "res_qid", "res_pred", "res_target", "res_overflow"):
        setattr(merged, name, jnp.concatenate([getattr(s, name) for s in shards]))
    merged.res_seen = shards[0].res_seen + shards[1].res_seen
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = merged.compute()

    def rank(r):
        def run():
            m = T.RetrievalMAP(sketched=True, sketch_capacity=cap, **CPU)
            sl = slice(r * 400, (r + 1) * 400)
            _feed(m, "torch", p[sl], t[sl], q[sl])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return _synced_compute(m)

        return run

    results, errors, _ = _run_ranks([rank(0), rank(1)], "torch")
    assert errors == [None, None]
    torch.testing.assert_close(results[0], results[1], rtol=0, atol=0)
    _close(results[0], want)
    if cap == 1024:
        single = T.RetrievalMAP(sketched=True, sketch_capacity=4096, **CPU)
        _feed(single, "torch", p, t, q)
        assert float(results[0]) == float(single.compute())


# -- keyed padded ----------------------------------------------------------------------------------


def _keyed_fuzz(port, ref, width=6, rows=24, steps=4, seed=0, reset_at=(1,)):
    n = port.num_tenants
    rng = np.random.RandomState(seed)
    for step in range(steps):
        ids = rng.randint(0, n, rows)
        preds, target = rng.rand(rows, width).astype(np.float32), rng.randint(0, 2, (rows, width))
        mask = np.arange(width)[None, :] < rng.randint(0, width + 1, rows)[:, None]
        port.update(_t(ids), _t(preds), _t(target), mask=_t(mask))
        ref.update(_j(ids), _j(preds), _j(target), mask=_j(mask))
        if step in reset_at:
            victims = rng.choice(n, size=2, replace=False)
            port.reset(tenant_ids=_t(victims))
            ref.reset(tenant_ids=_j(victims))


@pytest.mark.parametrize("name", _CLASSES)
def test_keyed_padded_parity_fuzz(name):
    """``tests/wrappers/test_multitenant.py:138-147`` for every member: the
    tenant axis on the query-row axis, each row a ``(1, D)`` batch of its
    tenant; ``query_total`` exactly, ``value_sum`` and the per-tenant values
    within float32 rounding; both leaves through the merge."""
    kwargs = {"k": 3} if name not in ("RetrievalMAP", "RetrievalMRR") else {}
    port = T.KeyedMetric(getattr(T, name)(padded=True, **kwargs, **CPU), 4, **CPU)
    ref = J.KeyedMetric(getattr(J, name)(padded=True, **kwargs), 4)
    _common.reset_dispatch_counters()
    _keyed_fuzz(port, ref)
    assert _common.dispatch_count("segment_merge", "torch") == 4  # one per update: both leaves in it
    np.testing.assert_array_equal(port.query_total.numpy(), np.asarray(ref.query_total))
    assert port.query_total.dtype == torch.int32 and port.value_sum.dtype == torch.float32
    np.testing.assert_allclose(port.value_sum.numpy(), np.asarray(ref.value_sum), rtol=1e-6, atol=1e-6)
    _close(port.compute(), ref.compute())
    # the same rows through independent per-tenant instances
    rng = np.random.RandomState(0)
    insts = [getattr(T, name)(padded=True, **kwargs, **CPU) for _ in range(4)]
    for step in range(4):
        ids = rng.randint(0, 4, 24)
        preds, target = rng.rand(24, 6).astype(np.float32), rng.randint(0, 2, (24, 6))
        mask = np.arange(6)[None, :] < rng.randint(0, 7, 24)[:, None]
        for tenant in range(4):
            sel = ids == tenant
            if sel.any():
                _feed(insts[tenant], "torch", preds[sel], target[sel], mask=mask[sel])
        if step == 1:
            for v in rng.choice(4, size=2, replace=False):
                insts[v].reset()
    for tenant, inst in enumerate(insts):
        assert int(inst.query_total) == int(port.query_total[tenant])


def test_keyed_padded_precision_matches_the_jax_keyed_metric():
    """The JAX test's own case: ``KeyedMetric(RetrievalPrecision(padded=True,
    k=3), 4)`` with no mask."""
    port = T.KeyedMetric(T.RetrievalPrecision(padded=True, k=3, **CPU), 4, **CPU)
    ref = J.KeyedMetric(J.RetrievalPrecision(padded=True, k=3), 4)
    rng = np.random.RandomState(0)
    for _ in range(4):
        ids = rng.randint(0, 4, 24)
        preds, target = rng.rand(24, 6).astype(np.float32), rng.randint(0, 2, (24, 6))
        port.update(_t(ids), _t(preds), _t(target))
        ref.update(_j(ids), _j(preds), _j(target))
    np.testing.assert_array_equal(port.query_total.numpy(), np.asarray(ref.query_total))
    _close(port.compute(), ref.compute())


def test_keyed_padded_collection_matches_the_jax_collection_and_compiles_without_host_reads():
    def members(pkg, **device):
        return [pkg.RetrievalMAP(padded=True, **device), pkg.RetrievalMRR(padded=True, **device),
                pkg.RetrievalNormalizedDCG(padded=True, k=3, **device)]

    port = T.MultiTenantCollection(members(T, **CPU), 16, validate_ids=False, **CPU)
    ref = J.MultiTenantCollection(members(J), 16, validate_ids=False)
    rng = np.random.RandomState(31)
    ids = rng.randint(-1, 16, (5, 40))
    preds, target = rng.rand(5, 40, 8).astype(np.float32), rng.randint(0, 2, (5, 40, 8))
    mask = np.arange(8)[None, None, :] < rng.randint(0, 9, (5, 40))[..., None]
    _common.reset_dispatch_counters()
    for i in range(5):
        port.update(_t(ids[i]), _t(preds[i]), _t(target[i]), mask=_t(mask[i]))
        ref.update(_j(ids[i]), _j(preds[i]), _j(target[i]), mask=_j(mask[i]))
    assert port.state_bundles == 3
    assert _common.dispatch_count("segment_merge", "torch") == 5  # one per update, over the three bundles
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name])
    compiled, many = (T.MultiTenantCollection(members(T, **CPU), 16, validate_ids=False, **CPU) for _ in range(2))
    compiled.warmup(_t(ids[0]), _t(preds[0]), _t(target[0]), mask=_t(mask[0]))
    with no_host_reads():
        for i in range(5):
            compiled.update(_t(ids[i]), _t(preds[i]), _t(target[i]), mask=_t(mask[i]))
        many.update_many(_t(ids), _t(preds), _t(target), mask=_t(mask))
    for other in (compiled, many):
        for owner, km in port._keyed.items():
            torch.testing.assert_close(other._keyed[owner].query_total, km.query_total, rtol=0, atol=0)
            torch.testing.assert_close(other._keyed[owner].value_sum, km.value_sum, rtol=1e-6, atol=1e-6)


def test_keyed_padded_update_rejects_bad_targets_before_the_vmap():
    keyed = T.RetrievalMAP(padded=True, **CPU).keyed(4)
    with pytest.raises(ValueError, match="binary"):
        keyed.update(_t(np.array([0, 1])), _t(np.ones((2, 3), np.float32)), _t(np.full((2, 3), 2)))
    with pytest.raises(ValueError, match="floats"):
        keyed.update(_t(np.array([0, 1])), _t(np.ones((2, 3), np.int64)), _t(np.zeros((2, 3), np.int64)))


# -- helpers ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_get_group_indexes_matches_the_jax_package(seed):
    from metrics_tpu.utilities.data import get_group_indexes as j_get_group_indexes
    from metrics_tpu_torch.utilities.data import get_group_indexes

    rng = np.random.RandomState(seed)
    idx = rng.randint(-3, [1, 5, 40][seed], (6, 7))
    got, want = get_group_indexes(_t(idx)), j_get_group_indexes(jnp.asarray(idx))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("sketched", [False, True])
def test_query_ids_wrap_to_int32_as_in_the_jax_package(sketched):
    """Ids are cast to int32 (wrapping) before grouping and hashing, so ids
    5 and 2^32 + 5 are one query in both packages."""
    idx = np.array([5, 2**32 + 5, 7, 7, -2**33 + 7, 2**40], np.int64)
    preds = np.array([0.9, 0.1, 0.4, 0.8, 0.3, 0.2], np.float32)
    target = np.array([0, 1, 1, 0, 0, 1])
    kwargs = {"sketched": True, "sketch_capacity": 16} if sketched else {}
    jm, tm = _pair("RetrievalMAP", **kwargs)
    for m, pkg in ((jm, "jax"), (tm, "torch")):
        _feed(m, pkg, preds, target, idx)
    if sketched:
        _assert_reservoir_equal(tm, jm)
    _close(tm.compute(), jm.compute())
