"""``update_many``: K stacked micro-batches in one compiled dispatch, and the
keyed compiled update, against the JAX package.

Mirrors ``tests/bases/test_update_many.py`` case by case, and adds the keyed
forms (``KeyedMetric``/``MultiTenantCollection`` ``update_many`` and
``warmup``, ``metrics_tpu/wrappers/multitenant.py:746,764,1405,1454``). The
same numpy batches (``np.random.RandomState``) go through the JAX object and
the port's on the CPU, where the K updates run unrolled in one program under
the trace scope (one CUDA graph on the card). States equal K eager updates
exactly; values agree within 1e-6; the dispatch counters equal the JAX
package's.
"""
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

CPU = {"device": "cpu"}
K, B, NC = 5, 32, 3
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
def stacked():
    rng = np.random.RandomState(11)
    probs = rng.rand(K, B, NC).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    return probs, rng.randint(0, NC, (K, B))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _counters(pkg_obs, key, names=COMPILED_COUNTERS):
    counters = pkg_obs.snapshot()["metrics"].get(key, {}).get("counters", {})
    return {k: v for k, v in counters.items() if k in names}


def _same_states(a, b):
    for name in b._defaults:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _close(got, want, atol=1e-6):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], atol)
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_matches_k_eager_updates(stacked):
    sp, st = stacked
    many, oracle, jm = T.Accuracy(**CPU), T.Accuracy(**CPU), J.Accuracy()
    many.update_many(*_t(sp, st))
    jm.update_many(*_j(sp, st))
    for i in range(K):
        oracle.update(*_t(sp[i], st[i]))
    _same_states(many, oracle)
    assert many.correct.dtype == torch.int32
    assert torch.equal(many.compute(), oracle.compute())
    _close(many.compute(), jm.compute())
    assert _counters(tobs, many.telemetry_key) == _counters(jobs, jm.telemetry_key)


def test_repeated_calls_accumulate(stacked):
    sp, st = stacked
    many, oracle = T.Accuracy(**CPU), T.Accuracy(**CPU)
    many.update_many(*_t(sp, st))
    many.update_many(*_t(sp, st))
    for i in range(K):
        oracle.update(*_t(sp[i], st[i]))
        oracle.update(*_t(sp[i], st[i]))
    assert torch.equal(many.compute(), oracle.compute())


def test_capacity_curve_metric():
    rng = np.random.RandomState(2)
    scores = rng.rand(K, B).astype(np.float32)
    labels = rng.randint(0, 2, (K, B))
    many, oracle = T.AUROC(capacity=K * B, **CPU), T.AUROC(capacity=K * B, **CPU)
    jm = J.AUROC(capacity=K * B)
    many.update_many(*_t(scores, labels))
    jm.update_many(*_j(scores, labels))
    for i in range(K):
        oracle.update(*_t(scores[i], labels[i]))
    _same_states(many, oracle)
    assert torch.equal(many.compute(), oracle.compute())
    _close(many.compute(), jm.compute())


def test_stacked_kwargs_and_scalar_broadcast():
    rng = np.random.RandomState(4)
    values = rng.rand(K, B).astype(np.float32)
    weights = rng.rand(K, B).astype(np.float32)
    many, oracle, jm = T.AverageMeter(**CPU), T.AverageMeter(**CPU), J.AverageMeter()
    many.update_many(*_t(values), weight=_t(weights)[0])
    jm.update_many(*_j(values), weight=_j(weights)[0])
    for i in range(K):
        oracle.update(*_t(values[i]), weight=_t(weights[i])[0])
    np.testing.assert_allclose(many.compute().numpy(), oracle.compute().numpy(), rtol=1e-6)
    _close(many.compute(), jm.compute())
    many2, oracle2, jm2 = T.AverageMeter(**CPU), T.AverageMeter(**CPU), J.AverageMeter()
    many2.update_many(*_t(values), weight=2.0)
    jm2.update_many(*_j(values), weight=2.0)
    for i in range(K):
        oracle2.update(*_t(values[i]), weight=torch.full((B,), 2.0))
    np.testing.assert_allclose(many2.compute().numpy(), oracle2.compute().numpy(), rtol=1e-6)
    _close(many2.compute(), jm2.compute())


class _Split(T.Metric):
    """A metric whose ``update`` branches on the host on a ``bool`` flag
    (the JAX package's ``FID(...)(imgs, real=True)`` pattern)."""

    def __init__(self):
        super().__init__(**CPU)
        self.add_state("real", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("fake", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x, real: bool):
        if real:
            self.real = self.real + x.sum()
        else:
            self.fake = self.fake + x.sum()

    def compute(self):
        return self.real - self.fake


def test_static_bool_flag():
    rng = np.random.RandomState(5)
    real, fake = _t(rng.rand(3, 4).astype(np.float32), rng.rand(3, 4).astype(np.float32))
    many, oracle = _Split(), _Split()
    many.update_many(real, real=True)
    many.update_many(fake, real=False)
    for i in range(3):
        oracle.update(real[i], real=True)
        oracle.update(fake[i], real=False)
    assert torch.equal(many.compute(), oracle.compute())
    assert many._update_many_fn._cache_size() == 2  # one program per flag value


def test_one_dispatch_per_k_updates(stacked):
    sp, st = stacked
    m, jm = T.Accuracy(**CPU), J.Accuracy()
    for _ in range(2):
        m.update_many(*_t(sp, st))
        jm.update_many(*_j(sp, st))
    counters = _counters(tobs, m.telemetry_key)
    assert counters["update_many_calls"] == 2
    assert counters["update_many_batches"] == 2 * K
    assert counters["update_many_dispatches"] == 2
    assert m._update_many_fn._cache_size() == 1
    assert counters == _counters(jobs, jm.telemetry_key)
    # the plain kernel of each micro-batch runs once per micro-batch
    assert _common.dispatch_count("stat_scores_counts", "torch") == 0  # micro Accuracy counts without B1
    p = T.Precision(average="macro", num_classes=NC, **CPU)
    p.update_many(*_t(sp, st))
    assert _common.dispatch_count("stat_scores_counts", "torch") == K


def test_donation_in_place_and_opt_out(stacked):
    sp, st = stacked
    m = T.Accuracy(**CPU)
    defaults = {n: d.clone() for n, d in m._defaults.items()}
    m.update_many(*_t(sp, st))
    ptr = m.tp.data_ptr()
    m.update_many(*_t(sp, st))
    assert m.tp.data_ptr() == ptr
    for name, default in m._defaults.items():
        assert torch.equal(default, defaults[name]), name
    c = T.Accuracy(**CPU).jit_forward(donate=False)
    c.update_many(*_t(sp, st))
    before = c.tp  # kept, so that its memory is not reused
    c.update_many(*_t(sp, st))
    assert c.tp.data_ptr() != before.data_ptr()
    _same_states(m, c)


def test_alias_fallback(stacked):
    sp, st = stacked
    m = T.Accuracy(**CPU)
    m.update_many(*_t(sp, st))
    handle = m.total
    kept = handle.clone()
    with pytest.warns(UserWarning, match="referenced"):
        m.update_many(*_t(sp, st))
    assert torch.equal(handle, kept)
    del handle
    m.update_many(*_t(sp, st))
    oracle = T.Accuracy(**CPU)
    for _ in range(3):
        for i in range(K):
            oracle.update(*_t(sp[i], st[i]))
    assert torch.equal(m.compute(), oracle.compute())


def test_reset_between_calls(stacked):
    sp, st = stacked
    m = T.Accuracy(**CPU)
    m.update_many(*_t(sp, st))
    m.reset()
    m.update_many(*_t(sp, st))
    assert m._update_many_fn.cache_info() == {"entries": 1, "hits": 1, "misses": 1}
    oracle = T.Accuracy(**CPU)
    for i in range(K):
        oracle.update(*_t(sp[i], st[i]))
    assert torch.equal(m.compute(), oracle.compute())


def test_validation_errors(stacked):
    sp, st = stacked
    m = T.Accuracy(**CPU)
    with pytest.raises(ValueError, match="at least one stacked array"):
        m.update_many()
    with pytest.raises(ValueError, match="disagree on the micro-batch count"):
        m.update_many(*_t(sp, st[: K - 1]))
    with pytest.raises(ValueError, match="list states"):
        T.AUROC(**CPU).update_many(torch.zeros((2, 4)), torch.zeros((2, 4), dtype=torch.int32))
    comp = T.Accuracy(**CPU) + 1.0
    with pytest.raises(ValueError, match="Compositional"):
        comp.update_many(*_t(sp, st))


def test_pickle_drops_and_rebuilds_cache(stacked):
    sp, st = stacked
    m = T.Accuracy(**CPU)
    m.update_many(*_t(sp, st))
    clone = pickle.loads(pickle.dumps(m))
    assert clone._update_many_fn is None
    clone.update_many(*_t(sp, st))
    m.update_many(*_t(sp, st))
    assert torch.equal(clone.compute(), m.compute())


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------


def _members(pkg, **device):
    return [
        pkg.Accuracy(**device),
        pkg.Precision(average="macro", num_classes=NC, **device),
        pkg.Recall(average="macro", num_classes=NC, **device),
        pkg.F1(average="macro", num_classes=NC, **device),
    ]


def test_collection_matches_k_eager_updates(stacked):
    sp, st = stacked
    many, oracle = T.MetricCollection(_members(T, **CPU)), T.MetricCollection(_members(T, **CPU))
    jc = J.MetricCollection(_members(J))
    many.update_many(*_t(sp, st))
    jc.update_many(*_j(sp, st))
    for i in range(K):
        oracle.update(*_t(sp[i], st[i]))
    mc, oc = many.compute(), oracle.compute()
    assert set(mc) == set(oc)
    for k in mc:
        assert torch.equal(mc[k], oc[k]), k
    _close(mc, jc.compute())


def test_collection_one_dispatch(stacked):
    sp, st = stacked
    col, jc = T.MetricCollection(_members(T, **CPU)), J.MetricCollection(_members(J))
    col.update_many(*_t(sp, st))
    jc.update_many(*_j(sp, st))
    counters = _counters(tobs, col.telemetry_key)
    assert counters["update_many_calls"] == 1
    assert counters["update_many_batches"] == K
    assert col._update_many_fn._cache_size() == 1
    assert counters == _counters(jobs, jc.telemetry_key)
    skipped = ("update_dedup_skipped", "compute_group_count")
    assert _counters(tobs, col.telemetry_key, skipped) == _counters(jobs, jc.telemetry_key, skipped)


def test_collection_rejects_ineligible_member(stacked):
    sp, st = stacked
    col = T.MetricCollection([T.Accuracy(**CPU), T.AUROC(**CPU)])
    with pytest.raises(ValueError, match="AUROC"):
        col.update_many(*_t(sp, st))


def test_collection_member_change_invalidates_cache(stacked):
    sp, st = stacked
    col = T.MetricCollection([T.Accuracy(**CPU)])
    col.update_many(*_t(sp, st))
    assert col._update_many_fn is not None
    col.add_metrics(T.Precision(average="macro", num_classes=NC, **CPU))
    assert col._update_many_fn is None
    col.update_many(*_t(sp, st))
    oracle = T.Precision(average="macro", num_classes=NC, **CPU)
    for i in range(K):
        oracle.update(*_t(sp[i], st[i]))
    assert torch.equal(col["Precision"].compute(), oracle.compute())


def test_collection_member_change_invalidates_groups(stacked):
    sp, st = stacked
    kw = dict(average="macro", num_classes=NC, **CPU)
    col = T.MetricCollection([T.Precision(**kw), T.Recall(**kw)])
    col.update_many(*_t(sp, st))
    assert col.__dict__["_compute_groups"] == [("Precision", ["Precision", "Recall"])]
    assert col["Recall"].tp is col["Precision"].tp
    col.add_metrics(T.Accuracy(**CPU))
    assert col._update_many_fn is None and col.__dict__["_compute_groups"] is None
    assert col["Recall"].tp is not col["Precision"].tp  # each holds a state of its own again
    col.update_many(*_t(sp, st))
    oracle = T.MetricCollection([T.Precision(**kw), T.Recall(**kw)])
    for i in range(2 * K):
        oracle.update(*_t(sp[i % K], st[i % K]))
    assert torch.equal(col["Precision"].compute(), oracle.compute()["Precision"])
    assert torch.equal(col["Recall"].compute(), oracle.compute()["Recall"])


def test_collection_donation_in_place(stacked):
    sp, st = stacked
    col = T.MetricCollection(_members(T, **CPU))
    col.update_many(*_t(sp, st))
    ptrs = {n: col[n].tp.data_ptr() for n in ("Precision", "Recall")}
    col.update_many(*_t(sp, st))
    for n, p in ptrs.items():
        assert col[n].tp.data_ptr() == p, n


def test_mixed_update_many_and_jit_forward(stacked):
    sp, st = stacked
    m, oracle = T.Accuracy(**CPU).jit_forward(), T.Accuracy(**CPU)
    m(*_t(sp[0], st[0]))
    m.update_many(*_t(sp[1:], st[1:]))
    m(*_t(sp[0], st[0]))
    oracle.update(*_t(sp[0], st[0]))
    for i in range(1, K):
        oracle.update(*_t(sp[i], st[i]))
    oracle.update(*_t(sp[0], st[0]))
    assert torch.equal(m.compute(), oracle.compute())


def test_collection_reset_and_eager_steps_keep_the_group(stacked):
    """A reset() or an eager step leaves a group's members with equal
    values: they share the owner's tensors again, and the next compiled
    step replays the same graph."""
    sp, st = stacked
    col = T.MetricCollection(_members(T, **CPU)).jit_forward()
    oracle = T.MetricCollection(_members(T, **CPU))
    col(*_t(sp[0], st[0]))
    col.reset()
    col.update(*_t(sp[1], st[1]))
    col(*_t(sp[2], st[2]))
    for i in (1, 2):
        oracle.update(*_t(sp[i], st[i]))
    assert col["Recall"].tp is col["Precision"].tp
    assert col._jit_forward_fn.cache_info()["entries"] == 1
    for k, v in oracle.compute().items():
        assert torch.equal(col.compute()[k], v), k


def test_a_member_changed_out_of_band_leaves_its_group(stacked):
    sp, st = stacked
    col = T.MetricCollection(_members(T, **CPU)).jit_forward()
    col(*_t(sp[0], st[0]))
    col["Recall"].update(*_t(sp[1], st[1]))  # Recall alone
    col(*_t(sp[2], st[2]))
    assert [ns for _, ns in col.__dict__["_compute_groups"] if len(ns) > 1] == [["Precision", "F1"]]
    recall, precision = T.Recall(average="macro", num_classes=NC, **CPU), T.Precision(average="macro", num_classes=NC, **CPU)
    for i in (0, 1, 2):
        recall.update(*_t(sp[i], st[i]))
    for i in (0, 2):
        precision.update(*_t(sp[i], st[i]))
    assert torch.equal(col["Recall"].compute(), recall.compute())
    assert torch.equal(col["Precision"].compute(), precision.compute())


# ---------------------------------------------------------------------------
# keyed: KeyedMetric and MultiTenantCollection
# ---------------------------------------------------------------------------

N = 11


def _keyed_stream(seed=0, k=K, rows=24, invalid=True):
    rng = np.random.RandomState(seed)
    low, high = (-1, N + 2) if invalid else (0, N)
    ids = rng.randint(low, high, (k, rows))
    probs = rng.rand(k, rows, NC).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    return ids, probs, rng.randint(0, NC, (k, rows))


def _keyed_members(pkg, **device):
    kw = dict(average="macro", num_classes=NC, **device)
    return {"Accuracy": pkg.Accuracy(**device), "Precision": pkg.Precision(**kw), "Recall": pkg.Recall(**kw)}


def test_keyed_update_many_matches_k_updates_and_the_jax_package():
    ids, probs, target = _keyed_stream()
    tk = T.KeyedMetric(T.Precision(average="macro", num_classes=NC, **CPU), N, validate_ids=False, **CPU)
    oracle = T.KeyedMetric(T.Precision(average="macro", num_classes=NC, **CPU), N, validate_ids=False, **CPU)
    jk = J.KeyedMetric(J.Precision(average="macro", num_classes=NC), N, validate_ids=False)
    tk.update_many(*_t(ids, probs, target))
    jk.update_many(*_j(ids, probs, target))
    for i in range(K):
        oracle.update(*_t(ids[i], probs[i], target[i]))
    _same_states(tk, oracle)
    assert tk.tp.dtype == torch.int32
    _close(tk.compute(), jk.compute())
    assert _counters(tobs, tk.telemetry_key) == _counters(jobs, jk.telemetry_key)
    want = {"invalid_tenant_ids", "rows_routed", "occupancy", "top_traffic", "invalid_rate"}
    trep, jrep = tk.tenant_report(), jk.tenant_report()
    assert {k: trep[k] for k in want} == {k: jrep[k] for k in want}


def test_keyed_update_many_validates_ids_up_front():
    ids, probs, target = _keyed_stream()
    tk = T.KeyedMetric(T.Accuracy(**CPU), N, **CPU)
    with pytest.raises(ValueError, match="outside the valid range"):
        tk.update_many(*_t(ids, probs, target))
    with pytest.raises(ValueError, match=r"\(K, B\)"):
        tk.update_many(*_t(ids[0], probs[0], target[0]))


def test_keyed_warmup_then_update_replays():
    ids, probs, target = _keyed_stream(1)
    tk = T.KeyedMetric(T.Accuracy(**CPU), N, validate_ids=False, **CPU)
    jk = J.KeyedMetric(J.Accuracy(), N, validate_ids=False)
    eager = T.KeyedMetric(T.Accuracy(**CPU), N, validate_ids=False, **CPU)
    report = tk.warmup(*_t(ids[0], probs[0], target[0]))
    jk.warmup(*_j(ids[0], probs[0], target[0]))
    assert report["compiled_this_call"] and report["tenants"] == N
    assert not tk._update_called and int(tk.tp.sum()) == 0
    for i in range(K):
        tk.update(*_t(ids[i], probs[i], target[i]))
        jk.update(*_j(ids[i], probs[i], target[i]))
        eager.update(*_t(ids[i], probs[i], target[i]))
    _same_states(tk, eager)
    assert tk._keyed_update_fn.cache_info() == {"entries": 1, "hits": K, "misses": 1}
    _close(tk.compute(), jk.compute())
    names = ("keyed_update_dispatches", "warmup_calls", "warmup_compiles", "invalid_tenant_ids")
    assert _counters(tobs, tk.telemetry_key, names) == _counters(jobs, jk.telemetry_key, names)
    assert tk.tenant_report()["rows_routed"] == jk.tenant_report()["rows_routed"]


def test_keyed_jit_forward_enables_the_compiled_update():
    ids, probs, target = _keyed_stream(2)
    tk = T.KeyedMetric(T.Accuracy(**CPU), N, validate_ids=False, **CPU).jit_forward()
    eager = T.KeyedMetric(T.Accuracy(**CPU), N, validate_ids=False, **CPU)
    for i in range(K):
        tk.update(*_t(ids[i], probs[i], target[i]))
        eager.update(*_t(ids[i], probs[i], target[i]))
    _same_states(tk, eager)
    assert tk._keyed_update_fn.cache_info()["entries"] == 1
    tk.jit_forward(False)
    assert tk._keyed_update_fn is None
    tk.update(*_t(ids[0], probs[0], target[0]))  # eager again
    assert tk._keyed_update_fn is None


def test_multitenant_collection_update_many_and_warmup_match_the_jax_package():
    ids, probs, target = _keyed_stream(3)
    tc = T.MultiTenantCollection(_keyed_members(T, **CPU), N, validate_ids=False, **CPU)
    jc = J.MultiTenantCollection(_keyed_members(J), N, validate_ids=False)
    oracle = T.MultiTenantCollection(_keyed_members(T, **CPU), N, validate_ids=False, **CPU)
    report = tc.warmup(*_t(ids[0], probs[0], target[0]))
    jc.warmup(*_j(ids[0], probs[0], target[0]))
    assert report["compiled_this_call"] and report["state_bundles"] == 2 and report["members"] == 3
    tc.update_many(*_t(ids, probs, target))
    jc.update_many(*_j(ids, probs, target))
    for i in range(K):
        tc.update(*_t(ids[i], probs[i], target[i]))  # the warmed graph, replayed
        jc.update(*_j(ids[i], probs[i], target[i]))
    for _ in range(2):
        for i in range(K):
            oracle.update(*_t(ids[i], probs[i], target[i]))
    for owner, km in oracle._keyed.items():
        _same_states(tc._keyed[owner], km)
    _close(tc.compute(), jc.compute())
    names = ("update_many_calls", "update_many_batches", "update_many_dispatches", "warmup_calls", "warmup_compiles",
             "keyed_update_dispatches", "invalid_tenant_ids", "update_dedup_skipped")
    assert _counters(tobs, tc.telemetry_key, names) == _counters(jobs, jc.telemetry_key, names)
    want = {"invalid_tenant_ids", "rows_routed", "occupancy", "top_traffic", "invalid_rate"}
    trep, jrep = tc.tenant_report(), jc.tenant_report()
    assert {k: trep[k] for k in want} == {k: jrep[k] for k in want}
    assert tc._keyed_update_fn.cache_info() == {"entries": 1, "hits": K, "misses": 1}


def test_multitenant_collection_reset_keeps_its_graphs():
    """After reset() the next update_many copies the fresh state into the
    graph's tensors and replays: no new capture (nothing outside holds
    the old ones)."""
    ids, probs, target = _keyed_stream(4, invalid=False)
    tc = T.MultiTenantCollection(_keyed_members(T, **CPU), N, validate_ids=False, **CPU)
    oracle = T.MultiTenantCollection(_keyed_members(T, **CPU), N, validate_ids=False, **CPU)
    tc.warmup(*_t(ids[0], probs[0], target[0]))
    tc.update_many(*_t(ids, probs, target))
    tc.reset()
    tc.update_many(*_t(ids, probs, target))
    assert tc._update_many_fn.cache_info() == {"entries": 1, "hits": 1, "misses": 1}
    # on the CPU the program writes the live (reset) tensors in place; a
    # graph writes its own and hands them back (tests/test_torch_card.py)
    ptrs = {o: km.tp.data_ptr() for o, km in tc._keyed.items()}
    tc.update_many(*_t(ids, probs, target))
    assert {o: km.tp.data_ptr() for o, km in tc._keyed.items()} == ptrs
    tc.reset()
    tc.update_many(*_t(ids, probs, target))
    for i in range(K):
        oracle.update(*_t(ids[i], probs[i], target[i]))
    for owner, km in oracle._keyed.items():
        _same_states(tc._keyed[owner], km)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tc.update(*_t(ids[0], probs[0], target[0]))


def test_an_eager_step_after_an_out_of_band_change_keeps_the_member_apart(stacked):
    """A member changed alone (here: its own eager update) leaves its group
    before the collection's next eager step, which must not hand it the
    owner's tensors back."""
    sp, st = stacked
    col = T.MetricCollection(_members(T, **CPU)).jit_forward()
    col(*_t(sp[0], st[0]))
    col["Recall"].update(*_t(sp[1], st[1]))
    col.update(*_t(sp[2], st[2]))
    recall = T.Recall(average="macro", num_classes=NC, **CPU)
    for i in (0, 1, 2):
        recall.update(*_t(sp[i], st[i]))
    assert torch.equal(col["Recall"].compute(), recall.compute())
    assert col["Recall"].tp is not col["Precision"].tp and col["F1"].tp is col["Precision"].tp
