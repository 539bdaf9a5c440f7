"""The compiled step, ``jit_forward`` and ``warmup``, against the JAX package.

Mirrors ``tests/bases/test_jit_forward.py`` case by case: the same numpy
batches (``np.random.RandomState``) go through the JAX object under
``jit_forward`` and the port's object on the CPU, where the port's
:class:`~metrics_tpu_torch.utilities.aot.CompiledDispatch` runs the same
pure program under the trace scope on every call (the card captures it into
a CUDA graph: ``tests/test_torch_card.py``). Values agree within 1e-6
(counts exactly), dtypes are asserted apart, and the compile and dispatch
counters equal the JAX package's after the same calls. Where the JAX
package invalidates a donated buffer, the port writes the state tensor in
place: its tests pin that the tensor stays where it was and that a handle
held outside keeps its values.
"""
import contextlib
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.observability as jobs
import metrics_tpu_torch as T
import metrics_tpu_torch.observability as tobs
from metrics_tpu_torch.kernels import _common
from metrics_tpu_torch.utilities import data as tdata

CPU = {"device": "cpu"}
NB, B, NC = 5, 64, 7
#: the compiled path's counters, held against the JAX package's
COMPILED_COUNTERS = (
    "jit_forward_compiles", "forward_compiled_calls", "warmup_calls", "warmup_compiles", "update_many_calls",
    "update_many_batches", "update_many_dispatches", "jit_forward_alias_fallbacks", "keyed_update_dispatches",
    "update_traces",
)


@pytest.fixture(autouse=True)
def clean_telemetry():
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
    _common.reset_dispatch_counters()
    yield
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()


@pytest.fixture()
def stream():
    rng = np.random.RandomState(3)
    probs = rng.rand(NB, B, NC).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    return probs, rng.randint(0, NC, (NB, B))


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, atol=1e-6):
    """Port value == JAX value: counts exactly, floats within ``atol``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], atol)
        return
    if want is None:
        assert got is None
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _counters(pkg_obs, key):
    counters = pkg_obs.snapshot()["metrics"].get(key, {}).get("counters", {})
    return {k: v for k, v in counters.items() if k in COMPILED_COUNTERS}


def _same_counters(jm, tm):
    assert _counters(tobs, tm.telemetry_key) == _counters(jobs, jm.telemetry_key)


@contextlib.contextmanager
def no_host_reads():
    """Raise on a host read of a tensor (``item``, ``tolist``, ``bool``, ...)
    while a compiled program runs: what a CUDA graph capture refuses."""
    names = ["item", "tolist", "__bool__", "__int__", "__float__", "__index__", "numpy"]
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def guard(name):
        orig = saved[name]

        def wrapped(self, *args, **kwargs):
            if tdata._TRACE.active:
                raise AssertionError(f"Tensor.{name} read a value to the host inside a compiled program")
            return orig(self, *args, **kwargs)

        return wrapped

    for n in names:
        setattr(torch.Tensor, n, guard(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


def _both(name, **kw):
    return getattr(J, name)(**kw), getattr(T, name)(**kw, **CPU)


def test_matches_eager_forward_values_and_epoch(stream):
    probs, target = stream
    jm, tm = _both("Accuracy")
    jm.jit_forward()
    tm.jit_forward()
    eager = T.Accuracy(**CPU)
    for i in range(NB):
        vt = tm(*_t(probs[i], target[i]))
        _close(vt, jm(*_j(probs[i], target[i])))
        assert vt.dtype == torch.float32
        _close(vt, eager(*_t(probs[i], target[i])).numpy(), atol=1e-7)
    _close(tm.compute(), jm.compute())
    _same_counters(jm, tm)


def test_compute_on_step_false_accumulates_only(stream):
    probs, target = stream
    jm, tm = _both("Accuracy", compute_on_step=False)
    jm.jit_forward()
    tm.jit_forward()
    for i in range(NB):
        assert tm(*_t(probs[i], target[i])) is None
        jm(*_j(probs[i], target[i]))
    _close(tm.compute(), jm.compute())
    _same_counters(jm, tm)


def test_pickle_keeps_enablement_and_rebuilds_cache(stream):
    probs, target = stream
    m = T.Accuracy(**CPU).jit_forward()
    m(*_t(probs[0], target[0]))
    clone = pickle.loads(pickle.dumps(m))
    assert clone._jit_forward_enabled and clone._jit_forward_fn is None
    _close(clone.compute(), m.compute().numpy(), atol=1e-7)
    clone(*_t(probs[1], target[1]))
    m(*_t(probs[1], target[1]))
    _close(clone.compute(), m.compute().numpy(), atol=1e-7)


def test_reset_clone_disable(stream):
    probs, target = stream
    m = T.Accuracy(**CPU).jit_forward()
    m(*_t(probs[0], target[0]))
    m.reset()
    c = m.clone()
    assert c._jit_forward_enabled and c._jit_forward_fn is None
    m.jit_forward(False)
    assert not m._jit_forward_enabled and m._jit_forward_fn is None
    assert m(*_t(probs[0], target[0])).shape == ()


def test_weighted_kwarg_stream():
    rng = np.random.RandomState(5)
    jm, tm = _both("AverageMeter")
    jm.jit_forward()
    tm.jit_forward()
    for _ in range(3):
        v, w = rng.rand(16).astype(np.float32), rng.rand(16).astype(np.float32)
        _close(tm(*_t(v, w)), jm(*_j(v, w)))
    _close(tm.compute(), jm.compute())
    _same_counters(jm, tm)


def test_python_numbers_are_traced_not_baked(stream):
    """A python number rides a 0-d tensor filled on every call: a stream of
    values is one capture, each value seen (the JAX package's weak scalar)."""
    jm, tm = _both("AverageMeter")
    jm.jit_forward()
    tm.jit_forward()
    for value in (1.5, 2.5, -4.0):
        _close(tm(value), jm(value))
    _close(tm.compute(), jm.compute())
    assert tm._jit_forward_fn.cache_info() == {"entries": 1, "hits": 2, "misses": 1}
    _same_counters(jm, tm)


def test_refuses_unbounded_list_states():
    with pytest.raises(ValueError, match="list states"):
        T.AUROC(**CPU).jit_forward()


def test_capacity_mode_is_jittable(stream):
    rng = np.random.RandomState(6)
    scores = rng.rand(NB, B).astype(np.float32)
    labels = rng.randint(0, 2, (NB, B))
    jm, tm = _both("AUROC", capacity=NB * B)
    jm.jit_forward()
    tm.jit_forward()
    for i in range(NB):
        _close(tm(*_t(scores[i], labels[i])), jm(*_j(scores[i], labels[i])))
    _close(tm.compute(), jm.compute())
    _same_counters(jm, tm)


def test_refuses_dist_sync_on_step():
    with pytest.raises(ValueError, match="dist_sync_on_step"):
        T.Accuracy(dist_sync_on_step=True, **CPU).jit_forward()


def test_refuses_compositional_but_disable_is_noop():
    comp = T.Accuracy(**CPU) + 1.0
    with pytest.raises(ValueError, match="Compositional"):
        comp.jit_forward()
    comp.jit_forward(False)


def test_refuses_custom_pure_state_wrappers():
    # a wrapper whose pure state ({"inner"}) is not its registered states
    class Wrapped(T.Metric):
        def __init__(self):
            super().__init__(**CPU)
            self.inner = T.Accuracy(**CPU)
            self.add_state("hits", torch.zeros(()), dist_reduce_fx="sum")

        def init_state(self):
            return {"inner": self.inner.init_state()}

        def update(self, preds, target):
            self.inner.update(preds, target)

        def compute(self):
            return self.inner.compute()

    with pytest.raises(ValueError, match="pure-state protocol"):
        Wrapped().jit_forward()


def _members(pkg, **device):
    return [
        pkg.Accuracy(**device),
        pkg.Precision(average="macro", num_classes=NC, **device),
        pkg.Recall(average="macro", num_classes=NC, **device),
        pkg.F1(average="macro", num_classes=NC, **device),
    ]


def test_collection_single_program_parity(stream):
    probs, target = stream
    jc = J.MetricCollection(_members(J)).jit_forward()
    tc = T.MetricCollection(_members(T, **CPU)).jit_forward()
    eager = T.MetricCollection(_members(T, **CPU))
    for i in range(NB):
        vt = tc(*_t(probs[i], target[i]))
        _close(vt, jc(*_j(probs[i], target[i])))
        assert all(v.dtype == torch.float32 for v in vt.values())
        _close(vt, {k: v.numpy() for k, v in eager(*_t(probs[i], target[i])).items()}, atol=1e-7)
    _close(tc.compute(), jc.compute())
    # one program for the collection: the JAX package's group of P/R/F1, one update per group
    assert tc.__dict__["_compute_groups"] == [("Accuracy", ["Accuracy"]), ("Precision", ["Precision", "Recall", "F1"])]
    _same_counters(jc, tc)
    # the JAX package also traces every member's update once to fingerprint
    # its groups; the port groups by the exact static key without a trace,
    # so only the owners count the program's own trace of their update
    for (name, jm), tm in zip(jc.items(keep_base=True), tc.values()):
        jcount, tcount = _counters(jobs, jm.telemetry_key), _counters(tobs, tm.telemetry_key)
        assert tcount.pop("update_traces", 0) == (1 if name in ("Accuracy", "Precision") else 0)
        assert jcount.pop("update_traces") == (2 if name in ("Accuracy", "Precision") else 1)
        assert tcount == jcount
    tcount = tobs.snapshot()["metrics"][tc.telemetry_key]["counters"]
    jcount = jobs.snapshot()["metrics"][jc.telemetry_key]["counters"]
    assert tcount["update_dedup_skipped"] == jcount["update_dedup_skipped"]
    assert tcount["compute_group_count"] == jcount["compute_group_count"]


def test_collection_rejects_ineligible_member():
    with pytest.raises(ValueError, match="AUROC"):
        T.MetricCollection([T.Accuracy(**CPU), T.AUROC(**CPU)]).jit_forward()


def test_collection_validation_preserves_member_enablement(stream):
    probs, target = stream
    acc = T.Accuracy(**CPU).jit_forward()
    acc(*_t(probs[0], target[0]))
    fn = acc._jit_forward_fn
    col = T.MetricCollection([acc]).jit_forward()
    col.jit_forward(False)
    assert acc._jit_forward_enabled and acc._jit_forward_fn is fn


def test_collection_member_compute_on_step_false_returns_none(stream):
    probs, target = stream
    col = T.MetricCollection({"on": T.Accuracy(**CPU), "off": T.Accuracy(compute_on_step=False, **CPU)}).jit_forward()
    out = col(*_t(probs[0], target[0]))
    assert out["off"] is None
    assert out["on"].shape == ()
    _close(col.compute()["off"], col.compute()["on"].numpy(), atol=1e-7)


def test_collection_pickle(stream):
    probs, target = stream
    c = T.MetricCollection([T.Accuracy(**CPU)]).jit_forward()
    c(*_t(probs[0], target[0]))
    c2 = pickle.loads(pickle.dumps(c))
    assert c2._jit_forward_enabled and c2._jit_forward_fn is None
    c2(*_t(probs[1], target[1]))


def test_collection_add_metrics_after_jit_forward_invalidates_cache(stream):
    probs, target = stream
    col = T.MetricCollection([T.Accuracy(**CPU)]).jit_forward()
    col(*_t(probs[0], target[0]))
    assert col._jit_forward_fn is not None
    col.add_metrics(T.Precision(average="macro", num_classes=NC, **CPU))
    assert col._jit_forward_fn is None
    out = col(*_t(probs[1], target[1]))
    assert set(out) == {"Accuracy", "Precision"}
    jm = J.Precision(average="macro", num_classes=NC)
    jm.update(*_j(probs[1], target[1]))
    _close(col["Precision"].compute(), jm.compute())


def test_collection_add_metrics_after_jit_forward_rejects_ineligible(stream):
    probs, target = stream
    col = T.MetricCollection([T.Accuracy(**CPU)]).jit_forward()
    col(*_t(probs[0], target[0]))
    with pytest.raises(ValueError, match="AUROC"):
        col.add_metrics(T.AUROC(**CPU))
    assert "AUROC" not in col
    col(*_t(probs[1], target[1]))


def test_collection_setitem_after_jit_forward_invalidates_cache(stream):
    probs, target = stream
    col = T.MetricCollection([T.Accuracy(**CPU)]).jit_forward()
    col(*_t(probs[0], target[0]))
    col["Accuracy"] = T.Accuracy(**CPU)
    assert col._jit_forward_fn is None
    with pytest.raises(ValueError, match="list states"):
        col["Accuracy"] = T.AUROC(**CPU)


def test_collection_add_metrics_after_grouped_jit_forward(stream):
    probs, target = stream
    kw = dict(average="macro", num_classes=NC)
    jc = J.MetricCollection([J.Precision(**kw), J.Recall(**kw)]).jit_forward()
    tc = T.MetricCollection([T.Precision(**kw, **CPU), T.Recall(**kw, **CPU)]).jit_forward()
    jc(*_j(probs[0], target[0]))
    tc(*_t(probs[0], target[0]))
    assert tc.__dict__["_compute_groups"] == [("Precision", ["Precision", "Recall"])]
    jc.add_metrics(J.F1(**kw))
    tc.add_metrics(T.F1(**kw, **CPU))
    assert tc._jit_forward_fn is None and tc.__dict__["_compute_groups"] is None
    _close(tc(*_t(probs[1], target[1])), jc(*_j(probs[1], target[1])))
    # the fresh F1 missed batch 0: it stays out of the group, as in the JAX package
    assert list(jc.compute_group_report()["groups"].values()) == [["Precision", "Recall"]]
    assert [ns for _, ns in tc.__dict__["_compute_groups"] if len(ns) > 1] == [["Precision", "Recall"]]
    _close(tc.compute(), jc.compute())


def test_collection_setitem_after_grouped_jit_forward(stream):
    probs, target = stream
    kw = dict(average="macro", num_classes=NC)
    col = T.MetricCollection([T.Precision(**kw, **CPU), T.Recall(**kw, **CPU)]).jit_forward()
    col(*_t(probs[0], target[0]))
    replaced = col["Recall"]
    assert replaced.tp is col["Precision"].tp  # the group shares the owner's tensors
    col["Recall"] = T.Recall(**kw, **CPU)
    assert col._jit_forward_fn is None and col.__dict__["_compute_groups"] is None
    # the evicted member left with a state of its own, which later steps never write
    assert replaced.tp is not col["Precision"].tp
    kept = replaced.tp.clone()
    col(*_t(probs[1], target[1]))
    assert torch.equal(replaced.tp, kept)


def test_metric_pickle_from_before_the_compiled_step_loads(stream):
    probs, target = stream
    m = T.Accuracy(**CPU)
    m.update(*_t(probs[0], target[0]))
    legacy = m.__getstate__()
    legacy.pop("_jit_forward_enabled", None)
    clone = T.Accuracy.__new__(T.Accuracy)
    clone.__setstate__(legacy)
    assert clone._jit_forward_enabled is False
    assert clone(*_t(probs[1], target[1])).shape == ()
    m.update(*_t(probs[1], target[1]))
    _close(clone.compute(), m.compute().numpy(), atol=1e-7)


def test_collection_pickle_from_before_the_compiled_step_loads(stream):
    probs, target = stream
    legacy = T.MetricCollection([T.Accuracy(**CPU)]).__getstate__()
    legacy.pop("_jit_forward_enabled", None)
    clone = T.MetricCollection.__new__(T.MetricCollection)
    clone.__dict__.update(legacy)
    assert clone._jit_forward_enabled is False
    assert clone(*_t(probs[0], target[0]))["Accuracy"].shape == ()


def test_jitted_is_actually_compiled(stream):
    """One capture (here: one first run), then cache hits: the program's
    update traces once, and the plain kernel runs once per step."""
    probs, target = stream
    jm, tm = _both("Precision", average="macro", num_classes=NC)
    jm.jit_forward()
    tm.jit_forward()
    for i in range(3):
        tm(*_t(probs[i], target[i]))
        jm(*_j(probs[i], target[i]))
    fn = tm._jit_forward_fn
    assert fn._cache_size() == 1 and fn.cache_info() == {"entries": 1, "hits": 2, "misses": 1}
    assert _common.dispatch_count("stat_scores_counts", "torch") == 3
    _same_counters(jm, tm)


def test_no_host_read_inside_the_program(stream):
    """Inside the program nothing is read to the host (a capture refuses a
    synchronizing call); the guard itself does fire there."""
    probs, target = stream
    with no_host_reads():
        with pytest.raises(AssertionError, match="host"):
            with tdata.trace_scope():
                torch.zeros(()).item()
        col = T.MetricCollection({
            **{m.__class__.__name__: m for m in _members(T, **CPU)},
            "Specificity": T.Specificity(average="macro", num_classes=NC, **CPU),
            "ConfusionMatrix": T.ConfusionMatrix(num_classes=NC, **CPU),
            "IoU": T.IoU(num_classes=NC, **CPU),
            "CohenKappa": T.CohenKappa(num_classes=NC, **CPU),
            "MatthewsCorrcoef": T.MatthewsCorrcoef(num_classes=NC, **CPU),
        }).jit_forward()
        col.warmup(*_t(probs[0], target[0]))
        for i in range(NB):
            col(*_t(probs[i], target[i]))
        curves = T.AUROC(num_classes=NC, sketched=True, **CPU).jit_forward()
        curves(*_t(probs[0], target[0]))
        capped = T.AveragePrecision(capacity=100, **CPU).jit_forward()
        capped(*_t(probs[0][:, 0], (target[0] == 1).astype(np.int64)))


def test_label_predictions_need_num_classes_inside_the_program():
    rng = np.random.RandomState(1)
    preds, target = rng.randint(0, NC, 32), rng.randint(0, NC, 32)
    m = T.Accuracy(**CPU).jit_forward()
    with pytest.raises(ValueError, match="num_classes"):
        m(*_t(preds, target))
    ok = T.Accuracy(num_classes=NC, **CPU).jit_forward()
    jm = J.Accuracy(num_classes=NC).jit_forward()
    _close(ok(*_t(preds, target)), jm(*_j(preds, target)))


# ---------------------------------------------------------------------------
# in-place state updates (the JAX package's donation), the alias fallback
# ---------------------------------------------------------------------------


def _assert_equal_states(a, b):
    for name in a._defaults:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_donated_bit_identical_to_copying_classification(stream):
    probs, target = stream
    donated = T.Accuracy(**CPU).jit_forward()
    copying = T.Accuracy(**CPU).jit_forward(donate=False)
    for i in range(NB):
        assert torch.equal(donated(*_t(probs[i], target[i])), copying(*_t(probs[i], target[i])))
    _assert_equal_states(donated, copying)
    assert torch.equal(donated.compute(), copying.compute())


def test_donated_bit_identical_capacity_curve(stream):
    rng = np.random.RandomState(7)
    scores = rng.rand(NB, B).astype(np.float32)
    labels = rng.randint(0, 2, (NB, B))
    donated = T.AUROC(capacity=NB * B, **CPU).jit_forward()
    copying = T.AUROC(capacity=NB * B, **CPU).jit_forward(donate=False)
    for i in range(NB):
        donated(*_t(scores[i], labels[i]))
        copying(*_t(scores[i], labels[i]))
    _assert_equal_states(donated, copying)
    assert torch.equal(donated.compute(), copying.compute())


def test_donation_reuses_state_buffers_in_place(stream):
    probs, target = stream
    m = T.Accuracy(**CPU).jit_forward()
    m(*_t(probs[0], target[0]))
    ptr, oid = m.tp.data_ptr(), id(m.tp)  # no reference kept: that would be an alias
    m(*_t(probs[1], target[1]))
    assert m.tp.data_ptr() == ptr and id(m.tp) == oid
    c = T.Accuracy(**CPU).jit_forward(donate=False)
    c(*_t(probs[0], target[0]))
    before = c.tp  # kept, so that its memory is not reused
    c(*_t(probs[1], target[1]))
    assert c.tp.data_ptr() != before.data_ptr()


def test_in_place_update_keeps_the_state_where_it_lies(stream):
    """The port's counterpart of the JAX package's
    ``test_donation_invalidates_consumed_state``: nothing is invalidated;
    the state tensor stays where it lies across steps, and a handle kept
    outside (by the object or through a view) keeps its values."""
    probs, target = stream
    m = T.Accuracy(**CPU).jit_forward()
    m(*_t(probs[0], target[0]))
    ptrs = {n: getattr(m, n).data_ptr() for n in m._defaults}
    for i in (1, 2):
        m(*_t(probs[i], target[i]))
        assert {n: getattr(m, n).data_ptr() for n in m._defaults} == ptrs
    view = m.total.view(1)
    kept = view.clone()
    with pytest.warns(UserWarning, match="referenced"):
        m(*_t(probs[3], target[3]))
    assert torch.equal(view, kept)
    m(*_t(probs[4], target[4]))
    assert torch.equal(view, kept)
    oracle = T.Accuracy(**CPU)
    for i in range(NB):
        oracle.update(*_t(probs[i], target[i]))
    assert torch.equal(m.compute(), oracle.compute())


def test_donation_defaults_survive_reset(stream):
    probs, target = stream
    m = T.Accuracy(**CPU).jit_forward()
    defaults = {n: d.clone() for n, d in m._defaults.items()}
    for i in range(3):
        m(*_t(probs[i], target[i]))
    for name, default in m._defaults.items():
        assert torch.equal(default, defaults[name]), name
    m.reset()
    v = m(*_t(probs[0], target[0]))
    assert torch.equal(v, T.Accuracy(**CPU)(*_t(probs[0], target[0])))


def test_alias_fallback_protects_external_handle(stream):
    probs, target = stream
    jm, tm = _both("Accuracy")
    jm.jit_forward()
    tm.jit_forward()
    tm(*_t(probs[0], target[0]))
    jm(*_j(probs[0], target[0]))
    handle = tm.correct
    kept = handle.clone()
    jhandle = jm.correct
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tm(*_t(probs[1], target[1]))
        assert len(w) == 1 and "referenced" in str(w[0].message)
        tm(*_t(probs[2], target[2]))
        assert len(w) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm(*_j(probs[1], target[1]))
        jm(*_j(probs[2], target[2]))
    assert torch.equal(handle, kept)
    del handle, jhandle
    tm(*_t(probs[3], target[3]))
    jm(*_j(probs[3], target[3]))
    _close(tm.compute(), jm.compute())
    counters = _counters(tobs, tm.telemetry_key)
    assert counters["jit_forward_alias_fallbacks"] == _counters(jobs, jm.telemetry_key)["jit_forward_alias_fallbacks"]


def test_alias_fallback_counted_in_telemetry(stream):
    probs, target = stream
    m = T.Accuracy(**CPU).jit_forward()
    m(*_t(probs[0], target[0]))
    handle = m.correct
    with pytest.warns(UserWarning, match="referenced"):
        m(*_t(probs[1], target[1]))
    del handle
    assert tobs.snapshot()["metrics"][m.telemetry_key]["counters"]["jit_forward_alias_fallbacks"] == 1


def test_collection_alias_fallback_and_parity(stream):
    probs, target = stream
    members = lambda pkg, **d: [pkg.Accuracy(**d), pkg.Precision(average="macro", num_classes=NC, **d)]  # noqa: E731
    col = T.MetricCollection(members(T, **CPU)).jit_forward()
    col(*_t(probs[0], target[0]))
    handle = col["Accuracy"].correct
    kept = handle.clone()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        col(*_t(probs[1], target[1]))
        assert len(w) == 1 and "Accuracy.correct" in str(w[0].message)
    assert torch.equal(handle, kept)
    del handle
    col(*_t(probs[2], target[2]))
    oracle = J.MetricCollection(members(J))
    for i in range(NB):
        oracle.update(*_j(probs[i], target[i]))
    col(*_t(probs[3], target[3]))
    col(*_t(probs[4], target[4]))
    _close(col.compute(), oracle.compute())


def test_donation_pickle_round_trip(stream):
    probs, target = stream
    m = T.Accuracy(**CPU).jit_forward()
    m(*_t(probs[0], target[0]))
    clone = pickle.loads(pickle.dumps(m))
    assert clone._jit_forward_enabled and clone._jit_forward_donate
    assert clone._jit_forward_fn is None and clone._update_many_fn is None
    assert clone(*_t(probs[1], target[1])).shape == ()
    m(*_t(probs[1], target[1]))
    assert torch.equal(clone.compute(), m.compute())
    c2 = pickle.loads(pickle.dumps(T.Accuracy(**CPU).jit_forward(donate=False)))
    assert c2._jit_forward_enabled and not c2._jit_forward_donate


def test_donation_collection_pickle_round_trip(stream):
    probs, target = stream
    col = T.MetricCollection([T.Accuracy(**CPU), T.Precision(average="macro", num_classes=NC, **CPU)]).jit_forward()
    col(*_t(probs[0], target[0]))
    c2 = pickle.loads(pickle.dumps(col))
    assert c2._jit_forward_enabled and c2._jit_forward_donate and c2._jit_forward_fn is None
    assert set(c2(*_t(probs[1], target[1]))) == {"Accuracy", "Precision"}
    assert set(c2(*_t(probs[2], target[2]))) == {"Accuracy", "Precision"}


def test_compute_async_clones_drop_the_graphs(stream):
    """``compute_async`` snapshots by a clone: graphs never copy, the clone
    drops them and gives the same value."""
    probs, target = stream
    col = T.MetricCollection([T.Accuracy(**CPU), T.Precision(average="macro", num_classes=NC, **CPU)]).jit_forward()
    for i in range(3):
        col(*_t(probs[i], target[i]))
    want = col.compute()
    got = col.compute_async().result(timeout=30)
    _close(got, {k: v.numpy() for k, v in want.items()}, atol=0)


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------


def test_warmup_precompiles_and_first_step_hits_cache(stream):
    probs, target = stream
    jm, tm = _both("Accuracy")
    jm.jit_forward()
    tm.jit_forward()
    report = tm.warmup(*_t(probs[0], target[0]))
    jm.warmup(*_j(probs[0], target[0]))
    assert report["compiled_this_call"] and report["donated"]
    assert report["compile_seconds"] > 0
    assert report["forward"]["available"] is False  # no cost analysis of a CUDA graph yet
    assert not tm._update_called
    assert tm.correct.item() == 0 and tm.total.item() == 0
    tm(*_t(probs[0], target[0]))
    jm(*_j(probs[0], target[0]))
    counters = _counters(tobs, tm.telemetry_key)
    assert counters["warmup_calls"] == 1 and counters["warmup_compiles"] == 1
    assert counters.get("jit_forward_compiles", 0) == 0
    assert tm._jit_forward_fn._cache_size() == 1
    again = tm.warmup(*_t(probs[1], target[1]))
    jm.warmup(*_j(probs[1], target[1]))
    assert not again["compiled_this_call"] and again["compile_seconds"] == 0.0
    _same_counters(jm, tm)
    events = [e for e in tobs.EVENTS.events() if e.kind == "compile" and e.metric == tm.telemetry_key]
    assert [e.payload["fresh"] for e in events] == [True, False]


def test_warmup_enables_jit_forward():
    m = T.Accuracy(**CPU)
    m.warmup(torch.zeros((4, NC)), torch.zeros((4,), dtype=torch.int64))
    assert m._jit_forward_enabled
    with pytest.raises(ValueError, match="list states"):
        T.AUROC(**CPU).warmup(torch.zeros((4,)), torch.zeros((4,), dtype=torch.int64))


def test_warmup_collection(stream):
    probs, target = stream
    jc = J.MetricCollection([J.Accuracy(), J.Precision(average="macro", num_classes=NC)])
    tc = T.MetricCollection([T.Accuracy(**CPU), T.Precision(average="macro", num_classes=NC, **CPU)])
    report = tc.warmup(*_t(probs[0], target[0]))
    jc.warmup(*_j(probs[0], target[0]))
    assert tc._jit_forward_enabled
    assert report["compiled_this_call"] and report["members"] == 2
    _close(tc(*_t(probs[0], target[0])), jc(*_j(probs[0], target[0])))
    assert tc._jit_forward_fn._cache_size() == 1
    _same_counters(jc, tc)


def test_computed_cache_never_written_under_caller(stream):
    """ConfusionMatrix.compute() returns the state tensor itself: a caller
    holding it is an alias (the copying graph runs), a discarded result
    (the internal cache alone) is cleared first and the step is in place."""
    probs, target = stream
    m = T.ConfusionMatrix(num_classes=NC, **CPU).jit_forward()
    m(*_t(probs[0], target[0]))
    m.compute()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m(*_t(probs[1], target[1]))
    m2 = T.ConfusionMatrix(num_classes=NC, **CPU).jit_forward()
    m2(*_t(probs[0], target[0]))
    held = m2.compute()
    kept = held.clone()
    with pytest.warns(UserWarning, match="referenced"):
        m2(*_t(probs[1], target[1]))
    assert torch.equal(held, kept)
