"""The port's keyed multi-tenant state against the JAX package's.

Mirrors ``tests/wrappers/test_multitenant.py``: the same numpy batches, with
the same tenant ids, go to a ``metrics_tpu`` keyed object and to its
``metrics_tpu_torch`` counterpart (``device="cpu"``, where the segment
scatter runs its plain version), over a few steps with interleaved partial
resets. Stacked integer states must be equal exactly, with the port's dtypes
asserted apart from the values (the JAX side runs with x64 on); per-tenant
values hold ``rtol=1e-6, atol=1e-7``, NaN in the same places.
"""
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as T
import metrics_tpu_torch.observability as tobs
from metrics_tpu.utilities.stacked import row_states as jax_row_states
from metrics_tpu_torch.kernels import _common
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities import checks
from metrics_tpu_torch.utilities import stacked as tstacked
from metrics_tpu_torch.utilities.convert import load_numpy_states
from metrics_tpu_torch.utilities.stacked import broadcast_stack, row_states, stack_pytrees, vmap_update
from metrics_tpu_torch.wrappers.multitenant import _pow2_at_least
from tests.helpers.keyed_leaves import MergedBeside, SmallLeaves

NC = 4
C = 10
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _zero_counters():
    _common.reset_dispatch_counters()
    yield
    _common.reset_dispatch_counters()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x)


def _assert_states(port_keyed, jax_keyed):
    for name in jax_keyed._child._defaults:
        got, want = getattr(port_keyed, name), np.asarray(getattr(jax_keyed, name))
        assert got.dtype == port_keyed._child._defaults[name].dtype, name
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def _assert_values(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


def _binary_batch(rng, rows=48):
    return rng.rand(rows).astype(np.float32), rng.randint(0, 2, rows)


def _probs_batch(rng, rows=40, c=NC):
    logits = rng.rand(rows, c).astype(np.float32)
    return logits / logits.sum(-1, keepdims=True), rng.randint(0, c, rows)


def _fuzz(port, ref, make_batch, steps=4, seed=0, reset_at=(1,)):
    """Drive the port's and the JAX package's keyed objects over the same
    routed batches, with partial resets of two tenants after the steps in
    ``reset_at``."""
    n = port.num_tenants
    rng = np.random.RandomState(seed)
    for step in range(steps):
        batch = make_batch(rng)
        ids = rng.randint(0, n, len(batch[0]))
        port.update(_t(ids), *[_t(b) for b in batch])
        ref.update(_j(ids), *[_j(b) for b in batch])
        if step in reset_at:
            victims = rng.choice(n, size=2, replace=False)
            port.reset(tenant_ids=_t(victims))
            ref.reset(tenant_ids=_j(victims))


def _compute_both(port, ref):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return port.compute(), ref.compute()


# ---------------------------------------------------------------- KeyedMetric parity


def test_keyed_binary_accuracy_matches_jax():
    port, ref = T.KeyedMetric(T.Accuracy(**CPU), 6, **CPU), J.KeyedMetric(J.Accuracy(), 6)
    _fuzz(port, ref, _binary_batch)
    _assert_states(port, ref)  # all-integer states: exact
    got, want = _compute_both(port, ref)
    assert got.dtype == torch.float32 and got.shape == (6,)
    _assert_values(got, want)


def test_keyed_macro_precision_matches_jax():
    kw = dict(average="macro", num_classes=NC)
    port, ref = T.KeyedMetric(T.Precision(**kw, **CPU), 5, **CPU), J.KeyedMetric(J.Precision(**kw), 5)
    _fuzz(port, ref, _probs_batch)
    _assert_states(port, ref)
    _assert_values(*_compute_both(port, ref))


_TOP_K = [("Accuracy", {}), ("Precision", {"average": "macro"}), ("Recall", {"average": "micro"}),
          ("F1", {"average": "macro"}), ("FBeta", {"average": "weighted", "beta": 0.5}),
          ("Specificity", {"average": "macro"}), ("StatScores", {"reduce": "macro"})]


@pytest.mark.parametrize("collection", [False, True], ids=["KeyedMetric", "MultiTenantCollection"])
@pytest.mark.parametrize("metric, metric_kw", _TOP_K)
def test_keyed_top_k_on_probabilities_matches_jax(metric, metric_kw, collection):
    """``top_k=2`` on probabilities under the keyed vmap: the top-k mask is
    an out-of-place scatter of the batched indices (an in-place one into a
    fresh tensor raised in ``torch.func.vmap``)."""
    kw = dict(top_k=2, num_classes=NC, **metric_kw)
    if collection:
        port = T.MultiTenantCollection({metric: getattr(T, metric)(**kw, **CPU)}, 5, **CPU)
        ref = J.MultiTenantCollection({metric: getattr(J, metric)(**kw)}, 5)
    else:
        port, ref = T.KeyedMetric(getattr(T, metric)(**kw, **CPU), 5, **CPU), J.KeyedMetric(getattr(J, metric)(**kw), 5)
    _fuzz(port, ref, _probs_batch)
    for got_keyed, want_keyed in ([(port._keyed[o], ref._keyed[o]) for o in ref._keyed] if collection
                                  else [(port, ref)]):
        _assert_states(got_keyed, want_keyed)
    got, want = _compute_both(port, ref)
    for g, w in ([(got[k], want[k]) for k in want] if collection else [(got, want)]):
        _assert_values(g, w)


def test_keyed_top_2_accuracy_gives_the_jax_package_s_values():
    rng = np.random.RandomState(0)
    p = rng.rand(64, 5).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    t, ids = rng.randint(0, 5, 64), rng.randint(0, 6, 64)
    port, ref = T.KeyedMetric(T.Accuracy(top_k=2, **CPU), 6, **CPU), J.KeyedMetric(J.Accuracy(top_k=2), 6)
    port.update(_t(ids), _t(p), _t(t))
    ref.update(_j(ids), _j(p), _j(t))
    got, want = _compute_both(port, ref)
    _assert_values(got, want)
    np.testing.assert_allclose(got.numpy(), [0.5, 0.3333, 0.5385, 0.2, 0.5455, 0.4167], atol=1e-4)


def _tied_probs():
    """Rows whose top k ties: four equal values, all zero (a keyed cohort's
    padding), a tie at the second and third places, a NaN (the largest for
    both packages)."""
    return np.array([[0.25] * 4, [0.0] * 4, [0.1, 0.3, 0.3, 0.3], [0.4, 0.2, 0.2, 0.2],
                     [np.nan, 0.1, 0.2, 0.3]], dtype=np.float32)


@pytest.mark.parametrize("route", ["eager", "vmap"])
@pytest.mark.parametrize("k", [2, 3])
def test_select_topk_keeps_the_lower_class_among_ties_as_lax_top_k(route, k):
    """The top k of tied probabilities are the lowest classes among the tied,
    as the JAX package's ``lax.top_k`` takes them, on a batch and on each row
    under ``torch.func.vmap``."""
    from metrics_tpu.utilities.data import select_topk as jax_select_topk
    from metrics_tpu_torch.utilities.data import select_topk

    probs = _tied_probs()
    if route == "eager":
        got = select_topk(_t(probs), k)
    else:
        got = torch.func.vmap(lambda row: select_topk(row, k))(_t(probs).unsqueeze(1)).squeeze(1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_select_topk(_j(probs), k)))
    np.testing.assert_array_equal(got.numpy()[:2, :k], 1)


@pytest.mark.parametrize("name,kw", [("Accuracy", dict(top_k=2)),
                                     ("Precision", dict(average="macro", num_classes=NC, top_k=2))])
def test_top_2_of_tied_rows_counts_as_the_jax_package(name, kw):
    """A top-2 metric over rows that tie every class, eager and keyed, gives
    the JAX package's values."""
    probs, target = _tied_probs()[:4], np.array([0, 2, 1, 3])
    port, ref = getattr(T, name)(**kw, **CPU), getattr(J, name)(**kw)
    port.update(_t(probs), _t(target))
    ref.update(_j(probs), _j(target))
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=0, atol=0)
    ids = np.array([0, 1, 0, 1])
    kport, kref = T.KeyedMetric(getattr(T, name)(**kw, **CPU), 2, **CPU), J.KeyedMetric(getattr(J, name)(**kw), 2)
    kport.update(_t(ids), _t(probs), _t(target))
    kref.update(_j(ids), _j(probs), _j(target))
    np.testing.assert_allclose(kport.compute().numpy(), np.asarray(kref.compute()), rtol=0, atol=0)


def test_the_scatters_outside_vmap_are_unchanged_bit_for_bit():
    """``select_topk``, ``tie_group_bounds`` and ``_rank_data`` against the
    in-place scatters they replace, on seeded inputs with ties."""
    from metrics_tpu_torch.functional.regression.spearman import _rank_data
    from metrics_tpu_torch.utilities.data import select_topk, tie_group_bounds

    rng = np.random.RandomState(3)
    probs = _t(rng.rand(50, 7).astype(np.float32))
    for k in (2, 3):
        top = torch.topk(probs, k, dim=1).indices
        want = torch.zeros(probs.shape, dtype=torch.int32).scatter_(1, top, 1)
        assert torch.equal(select_topk(probs, k), want)
    keys = torch.sort(_t(rng.randint(0, 20, 200))).values
    changed = keys[1:] != keys[:-1]
    n, idx = keys.shape[0], torch.arange(keys.shape[0])
    is_start = torch.cat([torch.ones(1, dtype=torch.bool), changed])
    is_end = torch.cat([changed, torch.ones(1, dtype=torch.bool)])
    group = torch.cumsum(is_start, 0) - 1
    starts = torch.zeros(n + 1, dtype=torch.int64).scatter_(0, torch.where(is_start, group, n), idx)[group]
    ends = torch.zeros(n + 1, dtype=torch.int64).scatter_(0, torch.where(is_end, group, n), idx)[group]
    got = tie_group_bounds(changed)
    assert torch.equal(got[0], starts) and torch.equal(got[1], ends)
    data = _t(rng.randint(0, 30, 300).astype(np.float32))
    order = torch.sort(data, stable=True).indices
    x = data[order]
    s_idx, e_idx = tie_group_bounds(x[1:] != x[:-1])
    ranks = torch.empty(300).scatter_(0, order, (s_idx + e_idx).float() / 2 + 1)
    assert torch.equal(_rank_data(data), ranks)


def _members(pkg, **device):
    kw = dict(average="macro", num_classes=C, **device)
    return {"Accuracy": pkg.Accuracy(**device), "Precision": pkg.Precision(**kw), "Recall": pkg.Recall(**kw),
            "F1": pkg.F1(**kw)}


def test_collection_matches_jax():
    port = T.MultiTenantCollection(_members(T, **CPU), 6, prefix="val_", **CPU)
    ref = J.MultiTenantCollection(_members(J), 6, prefix="val_")
    _fuzz(port, ref, lambda rng: _probs_batch(rng, rows=48, c=C), reset_at=(0, 2))
    assert port.state_bundles == 2 == ref.state_bundles
    assert port._layout == ref._layout == [("Accuracy", ["Accuracy"]), ("F1", ["F1", "Precision", "Recall"])]
    for owner in ref._keyed:
        _assert_states(port._keyed[owner], ref._keyed[owner])
    got, want = _compute_both(port, ref)
    assert sorted(got) == sorted(want) == ["val_Accuracy", "val_F1", "val_Precision", "val_Recall"]
    for name in want:
        assert got[name].dtype == torch.float32
        _assert_values(got[name], want[name])


def test_collection_update_runs_one_scatter_per_bundle_and_no_count_kernel():
    port = T.MultiTenantCollection(_members(T, **CPU), 4, **CPU)
    rng = np.random.RandomState(1)
    for _ in range(3):
        preds, target = _probs_batch(rng, rows=24, c=C)
        port.update(_t(rng.randint(0, 4, 24)), _t(preds), _t(target))
    # one merge an update for both bundles' eleven int32 leaves: no B3, no B4, no count kernel
    assert _common.dispatch_count("segment_merge", "torch") == 3
    for op in ("segment_scatter_add", "segment_scatter_max"):
        assert _common.dispatch_count(op, "torch") == 0 and _common.dispatch_count(op, "plain") == 0
    # one stacked B1 dispatch an update for the macro P/R/F1 bundle's rows
    assert _common.dispatch_count("stat_scores_counts", "torch") == 3
    for op in ("segment_merge", "segment_scatter_add", "segment_scatter_max", "stat_scores_counts"):
        assert _common.launch_count(op) == 0


def test_single_member_collection_accuracy_keeps_its_mode():
    """A one-member keyed collection decodes Accuracy's data mode from the
    stacked ``mode_code`` before its fan-out, so it equals the KeyedMetric.
    (The JAX package's one-member collection never sets the member's mode and
    computes tp / (tp + fn) on binary data instead; see ROADMAP queue C.)"""
    rng = np.random.RandomState(0)
    preds, target = _binary_batch(rng, rows=40)
    ids = rng.randint(0, 3, 40)
    coll = T.MultiTenantCollection([T.Accuracy(**CPU)], 3, **CPU)
    keyed, ref = T.KeyedMetric(T.Accuracy(**CPU), 3, **CPU), J.KeyedMetric(J.Accuracy(), 3)
    for m in (coll, keyed):
        m.update(_t(ids), _t(preds), _t(target))
    ref.update(_j(ids), _j(preds), _j(target))
    _assert_values(coll.compute()["Accuracy"], ref.compute())
    _assert_values(keyed.compute(), ref.compute())


# ---------------------------------------------------------------- tenant ids


def test_validate_ids_false_drops_invalid_ids_and_padding_band():
    """Ids -1, >= capacity and in the padding band [num_tenants, capacity)
    never reach a real tenant; the dropped count stays on the device."""
    port = T.KeyedMetric(T.Accuracy(**CPU), 3, validate_ids=False, capacity=5, **CPU)
    ref = J.KeyedMetric(J.Accuracy(), 3, validate_ids=False, capacity=5)
    clean = T.KeyedMetric(T.Accuracy(**CPU), 3, **CPU)
    ids = np.asarray([0, 99, -7, 2, 3, 4, 5, 1])
    preds = np.asarray([0.9, 0.5, 0.5, 0.2, 0.7, 0.6, 0.1, 0.8], np.float32)
    target = np.asarray([1, 0, 1, 0, 1, 1, 0, 1])
    port.update(_t(ids), _t(preds), _t(target))
    ref.update(_j(ids), _j(preds), _j(target))
    keep = (ids >= 0) & (ids < 3)
    clean.update(_t(ids[keep]), _t(preds[keep]), _t(target[keep]))
    _assert_states(port, ref)
    for name in clean._defaults:
        assert torch.equal(getattr(port, name)[:3], getattr(clean, name))
    _, invalid = port._segment_scatter(port.init_state(), _t(ids), (_t(preds), _t(target)), {})
    assert invalid.dtype == torch.int32 and invalid.ndim == 0 and int(invalid) == 3  # -7, 5, 99
    _assert_values(*_compute_both(port, ref))
    assert port.compute().shape == (3,)


def test_validate_ids_true_raises_the_jax_message():
    port, ref = T.KeyedMetric(T.Accuracy(**CPU), 3, **CPU), J.KeyedMetric(J.Accuracy(), 3)
    p, t = np.asarray([0.9, 0.1, 0.3], np.float32), np.asarray([1, 0, 1])
    for bad in ([0, 3, 5], [-1, 0, 1]):
        with pytest.raises(ValueError) as got:
            port.update(_t(bad), _t(p), _t(t))
        with pytest.raises(ValueError) as want:
            ref.update(_j(bad), _j(p), _j(t))
        assert str(got.value).split(" Fix")[0] == str(want.value).split(" Fix")[0]
    with pytest.raises(ValueError, match="integer array"):
        port.update(torch.tensor([0.5, 1.0, 0.0]), _t(p), _t(t))
    with pytest.raises(ValueError, match="rank-1"):
        port.update(torch.tensor([[0], [1], [2]]), _t(p), _t(t))
    assert all(int(getattr(port, s).sum()) == 0 for s in ("tp", "fp", "tn", "fn"))  # nothing scattered


def test_partial_reset_validates_and_preserves_others():
    keyed = T.KeyedMetric(T.Accuracy(**CPU), 4, **CPU)
    keyed.update(_t([0, 1, 2, 3]), _t(np.full(4, 0.9, np.float32)), _t([1, 1, 1, 1]))
    before = keyed.tp.clone()
    keyed.reset(tenant_ids=_t([1, 3]))
    assert torch.equal(keyed.tp[[0, 2]], before[[0, 2]])
    assert int(keyed.tp[[1, 3]].abs().sum()) == 0
    with pytest.raises(ValueError, match="outside the valid range"):
        keyed.reset(tenant_ids=_t([9]))
    keyed.reset()
    assert int(keyed.tp.sum()) == 0


def test_pure_apply_update_drops_invalid_ids():
    keyed = T.KeyedMetric(T.Accuracy(**CPU), 3, **CPU)
    state = keyed.apply_update(keyed.init_state(), _t([1, 77, -2]), _t(np.asarray([0.8, 0.1, 0.3], np.float32)),
                               _t([1, 1, 0]))
    want = keyed.apply_update(keyed.init_state(), _t([1]), _t(np.asarray([0.8], np.float32)), _t([1]))
    for name in state:
        assert torch.equal(state[name], want[name])
    assert int(keyed.tp.sum()) == 0  # the live state is untouched


# ---------------------------------------------------------------- rollups, pickle, gate


def test_rollups_match_jax():
    port = T.MultiTenantCollection(_members(T, **CPU), 5, **CPU)
    ref = J.MultiTenantCollection(_members(J), 5)
    rng = np.random.RandomState(2)
    ids = np.arange(40) % 5  # every tenant sees rows: the series are NaN-free
    preds, target = _probs_batch(rng, rows=40, c=C)
    port.update(_t(ids), _t(preds), _t(target))
    ref.update(_j(ids), _j(preds), _j(target))
    for largest in (True, False):
        vals, tenants = port.compute_topk(2, metric="F1", largest=largest)
        want_vals, _ = ref.compute_topk(2, metric="F1", largest=largest)
        _assert_values(vals, want_vals)
        series = port.compute()["F1"]
        assert torch.equal(series[tenants], vals)
    for q in (50.0, [10.0, 90.0]):
        _assert_values(port.compute_percentiles(q, metric="Precision"), ref.compute_percentiles(q, metric="Precision"))
    with pytest.raises(ValueError, match="pass metric="):
        port.compute_topk(2)
    with pytest.raises(KeyError, match="no member"):
        port.compute_topk(2, metric="Nope")
    with pytest.raises(ValueError, match=r"k must be in \[1, 5\]"):
        port.compute_topk(6, metric="F1")
    keyed = T.KeyedMetric(T.Accuracy(**CPU), 5, **CPU)
    keyed.update(_t(ids), _t(preds), _t(target))
    _assert_values(keyed.compute_topk(3)[0], torch.topk(keyed.compute(), 3)[0])
    _assert_values(keyed.compute_percentiles(50.0), torch.nanquantile(keyed.compute(), 0.5))
    stat = T.KeyedMetric(T.StatScores(reduce="macro", num_classes=C, **CPU), 5, **CPU)
    stat.update(_t(ids), _t(preds), _t(target))
    with pytest.raises(ValueError, match="one scalar per tenant"):
        stat.compute_topk(2)


def test_pickle_and_clone_keep_state():
    keyed = T.KeyedMetric(T.Accuracy(**CPU), 3, **CPU)
    keyed.update(_t([0, 2]), _t(np.asarray([0.9, 0.1], np.float32)), _t([1, 1]))
    for twin in (pickle.loads(pickle.dumps(keyed)), keyed.clone()):
        for name in keyed._defaults:
            assert torch.equal(getattr(twin, name), getattr(keyed, name))
        twin.update(_t([1]), _t(np.asarray([0.9], np.float32)), _t([1]))
        assert int(twin.tp[1]) == 1 and int(keyed.tp[1]) == 0
    coll = T.MultiTenantCollection(_members(T, **CPU), 3, **CPU)
    coll.update(_t([0, 1, 2]), *[_t(b) for b in _probs_batch(np.random.RandomState(0), rows=3, c=C)])
    twin = pickle.loads(pickle.dumps(coll))
    for name, value in coll.compute().items():
        assert torch.equal(twin.compute()[name], value)
    assert "num_tenants=3" in repr(keyed) and "num_tenants=3" in repr(coll)
    assert len(coll) == 4 and list(coll.keys()) == ["Accuracy", "F1", "Precision", "Recall"]
    assert isinstance(coll["F1"], T.F1)


class _MeanState(Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("x", torch.zeros(()), dist_reduce_fx="mean")

    def update(self, v):
        self.x = self.x + v.sum()

    def compute(self):
        return self.x


class _NoStates(_MeanState):
    def __init__(self, **kw):
        Metric.__init__(self, **kw)


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: T.StatScores(reduce="samples", **CPU), "unbounded list states"),
        (lambda: _MeanState(**CPU), "reductions the segment router cannot route"),
        (lambda: _NoStates(**CPU), "registers no states"),
        (lambda: T.Accuracy(dist_sync_on_step=True, **CPU), "dist_sync_on_step"),
        (lambda: "Accuracy", "metrics_tpu_torch.Metric"),
    ],
)
def test_keyed_gate_rejects_ineligible_metrics(make, match):
    with pytest.raises(ValueError, match=match):
        T.KeyedMetric(make(), 4, **CPU)
    if isinstance(make(), Metric):
        with pytest.raises(ValueError, match=match):
            T.MultiTenantCollection([make()], 4, **CPU)


def test_keyed_construction_checks():
    with pytest.raises(ValueError, match="num_tenants"):
        T.KeyedMetric(T.Accuracy(**CPU), 0, **CPU)
    with pytest.raises(ValueError, match="capacity"):
        T.KeyedMetric(T.Accuracy(**CPU), 4, capacity=3, **CPU)
    with pytest.raises(ValueError, match="keeps its states on"):
        T.KeyedMetric(T.Accuracy(**CPU), 4, device="meta")
    assert [_pow2_at_least(n) for n in (0, 1, 2, 3, 1000, 1024, 1025)] == [1, 1, 2, 4, 1024, 1024, 2048]
    keyed = T.KeyedMetric(T.Accuracy(**CPU), 3, capacity=8, **CPU)
    assert keyed.capacity == 8 and keyed.tp.shape == (8,) and keyed.mode_code.dtype == torch.int32


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.KeyedMetric(T.Accuracy(**CPU), 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.MultiTenantCollection([T.Accuracy(**CPU)], 3)


def test_group_layout_merges_only_identical_updates():
    coll = T.MetricCollection(_members(T, **CPU))
    assert coll._group_layout() == [("Accuracy", ["Accuracy"]), ("F1", ["F1", "Precision", "Recall"])]
    mixed = T.MetricCollection({"P4": T.Precision(average="macro", num_classes=4, **CPU),
                                "P5": T.Precision(average="macro", num_classes=5, **CPU),
                                "R4": T.Recall(average="macro", num_classes=4, **CPU),
                                "R4w": T.Recall(average="macro", num_classes=4, threshold=0.3, **CPU)})
    assert mixed._group_layout() == [("P4", ["P4", "R4"]), ("P5", ["P5"]), ("R4w", ["R4w"])]
    distinct = T.MetricCollection({"P4": T.Precision(average="macro", num_classes=4, **CPU),
                                   "P5": T.Precision(average="macro", num_classes=5, **CPU)})
    assert distinct._group_layout() == [("P4", ["P4"]), ("P5", ["P5"])]
    grouped = T.MultiTenantCollection(_members(T, **CPU), 3, **CPU)
    assert grouped.build() == {"F1": ["F1", "Precision", "Recall"]} and grouped.state_bundles == 2
    with pytest.raises(RuntimeError, match="no state bundles yet"):
        T.MultiTenantCollection(_members(T, **CPU), 3, **CPU).state_bundles


# ---------------------------------------------------------------- vmap safety


@pytest.mark.parametrize(
    "make,batch",
    [
        (lambda pkg, **d: pkg.Accuracy(**d), lambda rng: _binary_batch(rng, rows=12)),
        (lambda pkg, **d: pkg.Accuracy(**d), lambda rng: _probs_batch(rng, rows=12)),
        (lambda pkg, **d: pkg.Precision(average="macro", num_classes=NC, **d), lambda rng: _probs_batch(rng, rows=12)),
        (lambda pkg, **d: pkg.StatScores(reduce="macro", num_classes=NC, **d),
         lambda rng: (rng.randint(0, NC, 12), rng.randint(0, NC, 12))),
    ],
)
def test_row_states_equal_each_rows_own_update(monkeypatch, make, batch):
    """The vmapped per-row update equals the child's update run on each row
    alone, and the JAX package's row states; it reads nothing to the host."""
    preds, target = batch(np.random.RandomState(4))
    child = make(T, **CPU)

    def no_host_read(x):
        raise AssertionError("a host read inside the vmap")

    monkeypatch.setattr(checks, "_host_range", no_host_read)
    per_row = row_states(child, (_t(preds), _t(target)), {})
    monkeypatch.undo()
    want = jax_row_states(make(J), (_j(preds), _j(target)), {})
    for i in range(len(target)):
        alone = make(T, **CPU)
        alone.update(_t(preds[i:i + 1]), _t(target[i:i + 1]))
        for name, value in per_row.items():
            assert torch.equal(value[i], getattr(alone, name)), (name, i)
    for name, value in per_row.items():
        assert value.dtype == child._defaults[name].dtype
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[name]), err_msg=name)
    # a macro child: one stacked dispatch for all rows, beside each row's own update
    assert _common.dispatch_count("stat_scores_counts", "torch") == (len(target) + 1 if child.reduce == "macro" else 0)


@pytest.mark.parametrize(
    "make,batch",
    [
        (lambda pkg, **d: pkg.Precision(average="macro", num_classes=NC, **d), lambda rng: _probs_batch(rng, rows=12)),
        (lambda pkg, **d: pkg.Recall(average="macro", num_classes=NC, **d), lambda rng: _probs_batch(rng, rows=12)),
        (lambda pkg, **d: pkg.F1(average="macro", num_classes=NC, **d), lambda rng: _probs_batch(rng, rows=12)),
        (lambda pkg, **d: pkg.StatScores(reduce="macro", num_classes=NC, **d),
         lambda rng: (rng.randint(0, NC, 12), rng.randint(0, NC, 12))),
    ],
    ids=["Precision", "Recall", "F1", "StatScores"],
)
def test_length_1_macro_rows_reach_b1_as_one_stack(monkeypatch, make, batch):
    """Each keyed row is a length-1 batch under ``torch.func.vmap``; its
    macro counts go through B1's vmap rule, which hands the wrapper the whole
    ``(R, 1, C)`` stack in one dispatch (one launch on the card). The row
    states equal the JAX package's exactly."""
    from metrics_tpu_torch.kernels import stat_scores as st

    preds, target = batch(np.random.RandomState(7))
    shapes = []
    wrapper = st.stat_scores_counts_cuda
    monkeypatch.setattr(st, "stat_scores_counts_cuda",
                        lambda p, t, device="cuda": shapes.append(tuple(p.shape)) or wrapper(p, t, device=device))
    per_row = row_states(make(T, **CPU), (_t(preds), _t(target)), {})
    assert shapes == [(len(target), 1, NC)]
    assert _common.dispatch_count("stat_scores_counts", "torch") == 1
    want = jax_row_states(make(J), (_j(preds), _j(target)), {})
    assert sorted(per_row) == sorted(want)
    for name, value in per_row.items():
        assert value.dtype == torch.int32 and value.shape[0] == len(target), name
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[name]), err_msg=name)


def test_stack_helpers_and_vmap_update():
    child = T.Accuracy(**CPU)
    rng = np.random.RandomState(11)
    trees = [child.init_state() for _ in range(3)]
    stacked = stack_pytrees(trees)
    broadcast = broadcast_stack(child.init_state(), 3)
    for name in trees[0]:
        assert torch.equal(stacked[name], broadcast[name]) and stacked[name].shape == (3,)
    preds, target = (_t(x) for x in _binary_batch(rng, rows=12))
    xs = (preds.reshape(3, 4), target.reshape(3, 4))
    got = vmap_update(child)(stacked, xs)
    for i in range(3):
        alone = T.Accuracy(**CPU)
        alone.update(xs[0][i], xs[1][i])
        for name, value in got.items():
            assert torch.equal(value[i], getattr(alone, name)), (name, i)


def test_row_states_reject_misaligned_arguments():
    child = T.Accuracy(**CPU)
    with pytest.raises(ValueError, match="disagree on the event-row axis"):
        row_states(child, (torch.zeros(3), torch.zeros(4, dtype=torch.int64)), {})
    with pytest.raises(ValueError, match="at least one array argument"):
        row_states(child, (0.5,), {})


def test_label_preds_without_num_classes_raise_in_the_vmap():
    rng = np.random.RandomState(5)
    with pytest.raises(ValueError, match="must be given explicitly"):
        row_states(T.Accuracy(**CPU), (_t(rng.randint(0, 3, 6)), _t(rng.randint(0, 3, 6))), {})


def test_batch_value_checks_run_once_before_the_vmap():
    keyed = T.KeyedMetric(T.Precision(average="macro", num_classes=NC, **CPU), 3, **CPU)
    preds, _ = _probs_batch(np.random.RandomState(6), rows=6)
    with pytest.raises(ValueError, match="highest label in `target`"):
        keyed.update(_t([0, 1, 2, 0, 1, 2]), _t(preds), _t([0, 1, 2, 3, 4, 0]))
    with pytest.raises(ValueError, match="non-negative"):
        keyed.update(_t([0, 1, 2, 0, 1, 2]), _t(preds), _t([0, 1, -1, 3, 0, 0]))


# ---------------------------------------------------------------- batched rows


def _ties(probs):
    """Rows 0-1 tie every class and rows 2-3 are all zero, as the keyed
    cell's padding rows are: the top-1 is class 0 and the top-2 classes 0
    and 1 in both packages, the lower index first among ties. Row 4 ties the
    top two."""
    probs[0:2] = 1.0 / probs.shape[1]
    probs[2:4] = 0.0
    probs[4] = [0.4, 0.4] + [0.2 / (probs.shape[1] - 2)] * (probs.shape[1] - 2)
    return probs


def _multiclass_rows(rng, rows=16):
    return _ties(rng.rand(rows, NC).astype(np.float32)), rng.randint(0, NC, rows)


def _binary_rows(rng, rows=16):
    preds = rng.rand(rows).astype(np.float32)
    preds[0:2], preds[2:4] = 0.5, 0.0  # at the threshold, and padding
    return preds, rng.randint(0, 2, rows)


def _multilabel_rows(rng, rows=16):
    return _ties(rng.rand(rows, NC).astype(np.float32)), rng.randint(0, 2, (rows, NC))


def _label_rows(rng, rows=16):
    return rng.randint(0, NC, rows), rng.randint(0, NC, rows)


_MC = dict(num_classes=NC)
_ROWS_CASES = [
    ("multiclass", _multiclass_rows, "Accuracy", {}),
    ("multiclass", _multiclass_rows, "Accuracy", dict(top_k=2)),
    ("multiclass", _multiclass_rows, "Accuracy", dict(average="macro", **_MC)),
    ("multiclass", _multiclass_rows, "Precision", dict(average="macro", **_MC)),
    ("multiclass", _multiclass_rows, "Precision", dict(average="macro", top_k=2, **_MC)),
    ("multiclass", _multiclass_rows, "Recall", dict(average="micro")),
    ("multiclass", _multiclass_rows, "Recall", dict(average="micro", ignore_index=2, **_MC)),
    ("multiclass", _multiclass_rows, "F1", dict(average="macro", **_MC)),
    ("multiclass", _multiclass_rows, "Specificity", dict(average="macro", **_MC)),
    ("multiclass", _multiclass_rows, "StatScores", dict(reduce="micro", top_k=2)),
    ("multiclass", _multiclass_rows, "StatScores", dict(reduce="macro", ignore_index=1, **_MC)),
    ("binary", _binary_rows, "Accuracy", {}),
    ("binary", _binary_rows, "Precision", {}),
    ("binary", _binary_rows, "F1", dict(average="macro", num_classes=1)),
    ("binary", _binary_rows, "StatScores", dict(reduce="macro", num_classes=1)),
    ("multilabel", _multilabel_rows, "Accuracy", {}),
    ("multilabel", _multilabel_rows, "Recall", dict(average="macro", **_MC)),
    ("multilabel", _multilabel_rows, "Specificity", dict(average="micro")),
    ("multilabel", _multilabel_rows, "StatScores", dict(reduce="micro", top_k=2)),
    ("labels", _label_rows, "Accuracy", _MC),
    ("labels", _label_rows, "Precision", dict(average="macro", **_MC)),
    ("labels", _label_rows, "StatScores", dict(reduce="micro", **_MC)),
]


def _no_host_read(x):
    raise AssertionError("a host read in the row states")


def _no_vmap(*args):
    raise AssertionError("the vmap route was taken")


def _vmap_route(child, args):
    """The oracle: the child's rows through the vmap route alone."""
    child._row_states = lambda *a, **k: None
    return row_states(child, args, {})


@pytest.mark.parametrize("case,batch,name,kw", _ROWS_CASES,
                         ids=[f"{c[0]}-{c[2]}-" + ",".join(f"{k}={v}" for k, v in c[3].items()) for c in _ROWS_CASES])
def test_batched_rows_equal_the_vmap_route_and_the_jax_package(monkeypatch, case, batch, name, kw):
    """The batched-rows form, taken without a vmap and without a host read,
    equals the vmap route bit for bit and the JAX package's row states,
    in each leaf's dtype, tie and all-zero rows included; a macro child's
    rows reach B1 as one ``(B, 1, C)`` stack."""
    from metrics_tpu_torch.kernels import stat_scores as st

    preds, target = batch(np.random.RandomState(3))
    make = lambda pkg, **d: getattr(pkg, name)(**kw, **d)  # noqa: E731
    child = make(T, **CPU)
    shapes = []
    wrapper = st.stat_scores_counts_cuda
    monkeypatch.setattr(st, "stat_scores_counts_cuda",
                        lambda p, t, device="cuda": shapes.append(tuple(p.shape)) or wrapper(p, t, device=device))
    monkeypatch.setattr(checks, "_host_range", _no_host_read)
    monkeypatch.setattr(tstacked, "_vmapped_rows", _no_vmap)
    rows = row_states(child, (_t(preds), _t(target)), {})
    monkeypatch.undo()
    assert shapes == ([(len(target), 1, child.num_classes)] if child.reduce == "macro" else [])
    oracle = make(T, **CPU)
    vmapped = _vmap_route(oracle, (_t(preds), _t(target)))
    want = jax_row_states(make(J), (_j(preds), _j(target)), {})
    assert sorted(rows) == sorted(vmapped) == sorted(want)
    for leaf, value in rows.items():
        assert value.dtype == vmapped[leaf].dtype == child._defaults[leaf].dtype, leaf
        assert value.shape == (len(target),) + tuple(child._defaults[leaf].shape), leaf
        assert torch.equal(value, vmapped[leaf]), leaf
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[leaf]), err_msg=leaf)
    # Accuracy learns its mode from the batch as the vmap route does
    assert getattr(child, "mode", None) == getattr(oracle, "mode", None)


@pytest.fixture()
def tracer():
    tobs.reset()
    tobs.enable()
    yield tobs.TRACER
    tobs.reset()
    tobs.enable()


def test_a_mode_change_raises_the_vmap_route_s_error_before_any_state_changes():
    rng = np.random.RandomState(9)
    ids = rng.randint(0, 4, 12)
    binary, probs = _binary_batch(rng, rows=12), _probs_batch(rng, rows=12)
    messages = []
    for batched in (True, False):
        keyed = T.KeyedMetric(T.Accuracy(**CPU), 4, **CPU)
        if not batched:
            keyed._child._row_states = lambda *a, **k: None
        keyed.update(_t(ids), *(_t(x) for x in binary))
        before = {name: value.clone() for name, value in keyed._get_states().items()}
        with pytest.raises(ValueError, match="You can not use") as err:
            keyed.update(_t(ids), *(_t(x) for x in probs))
        messages.append(str(err.value))
        for name, value in before.items():
            assert torch.equal(getattr(keyed, name), value), name
    assert messages[0] == messages[1]


def _bypass_cases():
    rng = np.random.RandomState(12)
    probs, target = _probs_batch(rng, rows=10)
    ids = _t(rng.randint(0, 3, 10))
    regression = (_t(rng.randn(10).astype(np.float32)), _t(rng.randn(10).astype(np.float32)))
    labels = (_t(rng.randint(0, NC, 10)), _t(rng.randint(0, NC, 10)))
    return {
        "MeanSquaredError": lambda: T.KeyedMetric(T.MeanSquaredError(**CPU), 3, **CPU).update(ids, *regression),
        "ConfusionMatrix": lambda: T.KeyedMetric(T.ConfusionMatrix(num_classes=NC, **CPU), 3, **CPU).update(
            ids, _t(probs), _t(target)),
        "samplewise StatScores": lambda: row_states(
            T.StatScores(reduce="macro", mdmc_reduce="samplewise", num_classes=NC, **CPU), (_t(probs), _t(target)), {}),
        "labels without num_classes": lambda: row_states(T.Accuracy(**CPU), labels, {}),
    }


@pytest.mark.parametrize("case", ["MeanSquaredError", "ConfusionMatrix", "samplewise StatScores",
                                  "labels without num_classes"])
def test_the_vmap_route_stays_for_what_has_no_batched_rows(monkeypatch, tracer, case):
    """Children without the batched form, samplewise counts, and label
    predictions without ``num_classes`` (which raise as
    ``test_label_preds_without_num_classes_raise_in_the_vmap`` has it) go
    through the vmap; the request counts no batched bundle."""
    taken = []
    real = tstacked._vmapped_rows
    monkeypatch.setattr(tstacked, "_vmapped_rows", lambda metric, *a: taken.append(metric) or real(metric, *a))
    with tracer.span("probe"):
        if case == "labels without num_classes":
            with pytest.raises(ValueError, match="must be given explicitly"):
                _bypass_cases()[case]()
        else:
            _bypass_cases()[case]()
    assert len(taken) == 1
    (request,) = tracer.host_records()
    assert request.rows_batched == 0 and tracer.summary()["host"]["rows_batched"] == 0


def test_the_cell_s_collection_counts_two_batched_bundles_an_update(monkeypatch, tracer):
    """``MultiTenantCollection([Accuracy, macro P/R/F1])`` on float
    probabilities: both bundles take the batched rows on every update, and
    the states equal those of the vmap route."""
    coll = T.MultiTenantCollection(_members(T, **CPU), 6, **CPU)
    oracle = T.MultiTenantCollection(_members(T, **CPU), 6, **CPU)
    oracle.build()
    for km in oracle._keyed.values():
        km._child._row_states = lambda *a, **k: None
    rng = np.random.RandomState(14)
    batches = [(rng.randint(0, 6, 32),) + _probs_batch(rng, rows=32, c=C) for _ in range(3)]
    monkeypatch.setattr(tstacked, "_vmapped_rows", _no_vmap)
    for batch in batches:
        coll.update(*(_t(x) for x in batch))
    monkeypatch.undo()
    requests = tracer.host_records()
    assert [r.rows_batched for r in requests] == [2, 2, 2]
    assert tracer.summary()["host"]["rows_batched"] == 6
    for batch in batches:
        oracle.update(*(_t(x) for x in batch))
    assert [r.rows_batched for r in tracer.host_records()[3:]] == [0, 0, 0]
    for owner, km in oracle._keyed.items():
        for name, value in km._get_states().items():
            assert torch.equal(getattr(coll._keyed[owner], name), value), (owner, name)


def test_a_compiled_keyed_update_takes_the_batched_rows_and_equals_the_eager_one(monkeypatch, tracer):
    rng = np.random.RandomState(15)
    batches = [(rng.randint(0, 6, 24),) + _probs_batch(rng, rows=24, c=C) for _ in range(3)]
    compiled = T.MultiTenantCollection(_members(T, **CPU), 6, **CPU)
    eager = T.MultiTenantCollection(_members(T, **CPU), 6, **CPU)
    monkeypatch.setattr(tstacked, "_vmapped_rows", _no_vmap)
    compiled.warmup(*(_t(x) for x in batches[0]))
    for batch in batches:
        compiled.update(*(_t(x) for x in batch))
        eager.update(*(_t(x) for x in batch))
    # inside the compiled program's run nothing is recorded; its capture traced each bundle's child once
    assert [(r.attrs["path"], r.rows_batched) for r in tracer.host_records()] == [("compiled", 0), ("eager", 2)] * 3
    counters = tobs.snapshot()["metrics"]
    assert [counters[km._child.telemetry_key]["counters"]["update_traces"] for km in compiled._keyed.values()] == [1, 1]
    for owner, km in eager._keyed.items():
        for name, value in km._get_states().items():
            assert torch.equal(getattr(compiled._keyed[owner], name), value), (owner, name)
    assert compiled._keyed_update_fn.cache_info()["hits"] == 3


# ---------------------------------------------------------------- state carried across, sync


def test_state_carried_across_from_jax_mid_stream():
    port = T.MultiTenantCollection(_members(T, **CPU), 5, **CPU)
    ref = J.MultiTenantCollection(_members(J), 5)
    rng = np.random.RandomState(7)
    batches = [(rng.randint(0, 5, 32),) + _probs_batch(rng, rows=32, c=C) for _ in range(5)]
    for ids, preds, target in batches[:2]:
        ref.update(_j(ids), _j(preds), _j(target))
    load_numpy_states(port, {owner: {k: np.asarray(v) for k, v in km._get_states().items()}
                             for owner, km in ref._keyed.items()})
    for owner in ref._keyed:
        _assert_states(port._keyed[owner], ref._keyed[owner])
    for ids, preds, target in batches[2:]:
        port.update(_t(ids), _t(preds), _t(target))
        ref.update(_j(ids), _j(preds), _j(target))
    got, want = _compute_both(port, ref)
    for name in want:
        _assert_values(got[name], want[name])


def test_loaded_keyed_accuracy_decodes_its_mode_before_the_vmap():
    """A keyed Accuracy whose states were installed (its child's mode is
    None) decodes the mode from the stacked ``mode_code`` once, on the host,
    and computes under the vmap without reading a value there."""
    ref = J.KeyedMetric(J.Accuracy(), 4)
    rng = np.random.RandomState(8)
    preds, target = _binary_batch(rng, rows=32)
    ref.update(_j(rng.randint(0, 4, 32)), _j(preds), _j(target))
    port = T.KeyedMetric(T.Accuracy(**CPU), 4, **CPU)
    assert port._child.mode is None
    load_numpy_states(port, {k: np.asarray(v) for k, v in ref._get_states().items()})
    assert port._child.mode == "binary"
    _assert_values(*_compute_both(port, ref))
    fresh = T.KeyedMetric(T.Accuracy(**CPU), 4, **CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert fresh.compute().shape == (4,)  # never updated: mode None, no host read under the vmap


def test_injected_sync_doubles_sum_leaves_and_keeps_the_max_leaf():
    def gather(x, group=None):
        return [x, x]

    keyed = T.KeyedMetric(T.Accuracy(**CPU), 3, dist_sync_fn=gather, **CPU)
    plain = T.KeyedMetric(T.Accuracy(**CPU), 3, **CPU)
    rng = np.random.RandomState(9)
    preds, target = _binary_batch(rng, rows=30)
    ids = rng.randint(0, 3, 30)
    for m in (keyed, plain):
        m.update(_t(ids), _t(preds), _t(target))
    before = keyed._get_states()
    with keyed.sync_context(dist_sync_fn=gather):
        for name, value in before.items():
            want = value if name == "mode_code" else 2 * value
            assert torch.equal(getattr(keyed, name), want), name
    _assert_values(keyed.compute(), plain.compute())  # ratios of doubled counts
    for name, value in before.items():
        assert torch.equal(getattr(keyed, name), value)  # local states restored


# ---------------------------------------------------------------- regression: leaves of any dtype


def _regression_batch(rng, rows=32):
    return rng.randn(rows), rng.randn(rows)


def _assert_float_states(port_keyed, jax_keyed, rtol):
    """Integer leaves exactly; float leaves within ``rtol`` (the port's float32
    leaves against the JAX package's float64, or float64 against float64)."""
    for name in jax_keyed._child._defaults:
        got, want = getattr(port_keyed, name), np.asarray(getattr(jax_keyed, name))
        assert got.dtype == port_keyed._child._defaults[name].dtype, name
        assert tuple(got.shape) == want.shape, name
        if got.dtype.is_floating_point:
            np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_parity_fuzz_regression_with_interleaved_resets():
    port, ref = T.KeyedMetric(T.MeanSquaredError(**CPU), 5, **CPU), J.KeyedMetric(J.MeanSquaredError(), 5)
    _fuzz(port, ref, _regression_batch, steps=6, reset_at=(1, 3))
    assert port.sum_squared_error.dtype == torch.float32 and port.total.dtype == torch.int64
    _assert_float_states(port, ref, rtol=1e-6)
    got, want = _compute_both(port, ref)
    assert got.dtype == torch.float32
    _assert_values(got, want)
    # the merge took the float32 leaf, the plain route the int64 count, once per update
    assert _common.dispatch_count("segment_merge", "torch") == 6
    assert _common.dispatch_count("segment_scatter_add", "torch") == 0
    assert _common.dispatch_count("segment_scatter_add", "plain") == 6


def test_parity_fuzz_streaming_pearson_float64_moments():
    port = T.KeyedMetric(T.PearsonCorrcoef(streaming=True, **CPU), 4, **CPU)
    ref = J.KeyedMetric(J.PearsonCorrcoef(streaming=True), 4)
    _fuzz(port, ref, _regression_batch, steps=5, reset_at=(2,))
    assert port.sum_xy.dtype == torch.float64 and port.n_total.dtype == torch.int32
    _assert_float_states(port, ref, rtol=1e-12)
    got, want = _compute_both(port, ref)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_mixed_dtypes_and_empty_segments():
    """Leaf dtypes survive stacking; tenants that never receive a row keep
    their default state exactly."""
    child = T.MeanSquaredError(**CPU)
    keyed = T.KeyedMetric(child, 4, **CPU)
    for name, default in child._defaults.items():
        assert getattr(keyed, name).dtype == default.dtype
        assert tuple(getattr(keyed, name).shape) == (4,) + tuple(default.shape)
    ref = J.KeyedMetric(J.MeanSquaredError(), 4)
    ids, preds, target = [0, 2, 0], [1.0, 2.0, 3.0], [1.5, 2.5, 2.0]
    keyed.update(_t(ids), _t(preds), _t(target))
    ref.update(_j(ids), _j(preds), _j(target))
    for name, default in child._defaults.items():
        stacked = getattr(keyed, name)
        for empty in (1, 3):
            assert torch.equal(stacked[empty], default)
    assert int(keyed.total[0]) == 2 and int(keyed.total[2]) == 1
    _assert_float_states(keyed, ref, rtol=1e-6)


class _Int64AndFloat64Sums(Metric):
    """An int64 and a float64 ``"sum"`` leaf (beside a float32 one): the
    dtypes B3 does not take exactly."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("count", torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")
        self.add_state("moments", torch.zeros((3,), dtype=torch.float64), dist_reduce_fx="sum")
        self.add_state("f32", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, x, k):
        self.count = self.count + k.sum()
        self.moments = self.moments + torch.stack([x.sum(), (x * x).sum(), (x ** 3).sum()])
        self.f32 = self.f32 + x.sum().to(torch.float32)

    def compute(self):
        return self.moments[1] / self.count


class _JInt64AndFloat64Sums(J.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("count", jnp.zeros((), jnp.int64), dist_reduce_fx="sum")
        self.add_state("moments", jnp.zeros((3,), jnp.float64), dist_reduce_fx="sum")
        self.add_state("f32", jnp.zeros((), jnp.float32), dist_reduce_fx="sum")

    def update(self, x, k):
        self.count = self.count + k.sum()
        self.moments = self.moments + jnp.stack([x.sum(), (x * x).sum(), (x ** 3).sum()])
        self.f32 = self.f32 + x.sum().astype(jnp.float32)

    def compute(self):
        return self.moments[1] / self.count


def test_int64_and_float64_sum_leaves_key_exactly():
    """An int64 and a float64 ``"sum"`` leaf key exactly, as the JAX
    package's ``segment_sum`` keys them: counts past 2^24 stay exact, and
    float64 moments agree to float64 rounding. Ids outside the capacity are
    dropped; a tenant with no row keeps its default."""
    rng = np.random.RandomState(11)
    port = T.KeyedMetric(_Int64AndFloat64Sums(**CPU), 6, validate_ids=False, **CPU)
    ref = J.KeyedMetric(_JInt64AndFloat64Sums(), 6, validate_ids=False)
    for _ in range(4):
        ids = rng.randint(-1, 6, 40)
        ids[ids == 5] = 7  # tenant 5 never receives a row; 7 is outside the capacity
        x = rng.randn(40) * 1e3
        k = rng.randint(0, 2**40, 40).astype(np.int64)  # far past float32's 2^24
        port.update(_t(ids), _t(x), _t(k))
        ref.update(_j(ids), _j(x), _j(k))
    assert port.count.dtype == torch.int64 and port.moments.dtype == torch.float64
    np.testing.assert_array_equal(port.count.numpy(), np.asarray(ref.count))
    assert int(port.count[5]) == 0 and int(port.count.max()) > 2**41
    np.testing.assert_allclose(port.moments.numpy(), np.asarray(ref.moments), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(port.f32.numpy(), np.asarray(ref.f32), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=1e-12, equal_nan=True)
    # the merge once per update for the float32 leaf, one plain scatter per other dtype
    assert _common.dispatch_count("segment_merge", "torch") == 4
    assert _common.dispatch_count("segment_scatter_add", "torch") == 0
    assert _common.dispatch_count("segment_scatter_add", "plain") == 8


class _Float64Extrema(Metric):
    """Only leaves no kernel takes exactly: a float64 max, an int64 min and a
    float64 sum; the row counts then come from the plain route too."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("hi", torch.full((2,), -float("inf"), dtype=torch.float64), dist_reduce_fx="max")
        self.add_state("lo", torch.full((), 2**62, dtype=torch.int64), dist_reduce_fx="min")
        self.add_state("s", torch.zeros((), dtype=torch.float64), dist_reduce_fx="sum")

    def update(self, x, k):
        self.hi = torch.maximum(self.hi, torch.stack([x.max(), -x.min()]))
        self.lo = torch.minimum(self.lo, k.min())
        self.s = self.s + x.sum()

    def compute(self):
        return self.hi[0] + self.s


class _JFloat64Extrema(J.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("hi", jnp.full((2,), -jnp.inf, jnp.float64), dist_reduce_fx="max")
        self.add_state("lo", jnp.full((), 2**62, jnp.int64), dist_reduce_fx="min")
        self.add_state("s", jnp.zeros((), jnp.float64), dist_reduce_fx="sum")

    def update(self, x, k):
        self.hi = jnp.maximum(self.hi, jnp.stack([x.max(), -x.min()]))
        self.lo = jnp.minimum(self.lo, k.min())
        self.s = self.s + x.sum()

    def compute(self):
        return self.hi[0] + self.s


def test_extremal_leaves_of_any_dtype_and_counts_without_a_kernel():
    rng = np.random.RandomState(12)
    port = T.KeyedMetric(_Float64Extrema(**CPU), 5, validate_ids=False, **CPU)
    ref = J.KeyedMetric(_JFloat64Extrema(), 5, validate_ids=False)
    port.update(_t([0, 0]), _t([-0.0, 0.0]), _t([3, 4]))  # +0.0 wins a max over -0.0, as in XLA
    ref.update(_j([0, 0]), _j([-0.0, 0.0]), _j([3, 4]))
    routed = 2
    for _ in range(3):
        ids = rng.randint(-2, 7, 30)
        ids[ids == 3] = -1  # tenant 3 never receives a row
        routed += int(((ids >= 0) & (ids < 5)).sum())
        x = rng.randn(30)
        k = rng.randint(-(2**50), 2**50, 30).astype(np.int64)
        port.update(_t(ids), _t(x), _t(k))
        ref.update(_j(ids), _j(x), _j(k))
    for name in ("hi", "lo", "s"):
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        assert got.dtype == port._child._defaults[name].dtype
        np.testing.assert_array_equal(np.signbit(got.numpy()), np.signbit(want), err_msg=name)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12, err_msg=name)
    assert float(port.hi[3, 0]) == -np.inf and int(port.lo[3]) == 2**62
    assert _common.dispatch_count("segment_scatter_add", "torch") == 0
    assert _common.dispatch_count("segment_scatter_max", "torch") == 0
    # per update: the float64 sum, the counts, the max and the min
    assert _common.dispatch_count("segment_scatter_add", "plain") == 8
    assert _common.dispatch_count("segment_scatter_max", "plain") == 4
    assert _common.dispatch_count("segment_scatter_min", "plain") == 4
    # the ledger is fed the plain counts
    assert port.tenant_report()["rows_routed"] == routed


class _MergeLeaves(Metric):
    """An int32 sum with a non-zero default and float32 max/min leaves: the
    dtypes the merge takes."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", torch.tensor(5, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("hi", torch.full((2,), -float("inf")), dist_reduce_fx="max")
        self.add_state("lo", torch.tensor(float("inf")), dist_reduce_fx="min")

    def update(self, x, k):
        self.total = self.total + k.sum(dtype=torch.int32)
        self.hi = torch.maximum(self.hi, torch.stack([x.max(), -x.min()]))
        self.lo = torch.minimum(self.lo, x.min())

    def compute(self):
        return self.hi[0] + self.lo + self.total


class _JMergeLeaves(J.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", jnp.asarray(5, jnp.int32), dist_reduce_fx="sum")
        self.add_state("hi", jnp.full((2,), -jnp.inf, jnp.float32), dist_reduce_fx="max")
        self.add_state("lo", jnp.asarray(jnp.inf, jnp.float32), dist_reduce_fx="min")

    def update(self, x, k):
        self.total = self.total + k.sum(dtype=jnp.int32)
        self.hi = jnp.maximum(self.hi, jnp.stack([x.max(), -x.min()]))
        self.lo = jnp.minimum(self.lo, x.min())

    def compute(self):
        return self.hi[0] + self.lo + self.total


def _assert_bits(got, want, name):
    """Equal values, NaN where NaN, and the same sign of every zero."""
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(np.signbit(got) & ~np.isnan(got), np.signbit(want) & ~np.isnan(want), err_msg=name)


def test_int32_sums_past_2_24_key_exactly():
    """An int32 sum takes the merge's integer adds: a tenant's batch sum past
    2^24 of odd values, which float32 would round, equals numpy's int64 sum
    and the JAX package's ``segment_sum`` in int32."""
    rng = np.random.RandomState(21)
    port = T.KeyedMetric(_MergeLeaves(**CPU), 3, validate_ids=False, **CPU)
    ref = J.KeyedMetric(_JMergeLeaves(), 3, validate_ids=False)
    want = np.full(3, 5, np.int64)
    for _ in range(2):
        ids = rng.randint(-1, 3, 64)
        k = (rng.randint(2**21, 2**22, 64) | 1).astype(np.int32)
        x = rng.randn(64).astype(np.float32)
        port.update(_t(ids), _t(x), _t(k))
        ref.update(_j(ids), _j(x), _j(k))
        for tenant in range(3):
            want[tenant] += k[ids == tenant].astype(np.int64).sum()
    assert port.total.dtype == torch.int32 and want.min() > 2**24
    np.testing.assert_array_equal(port.total.numpy(), want)
    np.testing.assert_array_equal(port.total.numpy(), np.asarray(ref.total))
    assert _common.dispatch_count("segment_merge", "torch") == 2
    assert all(_common.dispatch_count(f"segment_scatter_{op}", path) == 0
               for op in ("add", "max", "min") for path in ("torch", "plain"))


def test_float32_extrema_meet_signed_zero_and_nan_states_as_the_jax_package():
    """Where a float32 extremum meets a state of the other signed zero or a
    NaN, the keyed update picks as the JAX package's does (XLA's order:
    +0.0 above -0.0, NaN on top), in one merge an update; tenant 4 never
    receives a row and keeps its defaults."""
    port = T.KeyedMetric(_MergeLeaves(**CPU), 5, **CPU)
    ref = J.KeyedMetric(_JMergeLeaves(), 5)
    k = np.ones(4, np.int32)
    for x in ([-0.0, 0.0, np.nan, 1.0], [0.0, -0.0, 5.0, np.nan]):
        x = np.asarray(x, np.float32)
        port.update(_t(np.arange(4)), _t(x), _t(k))
        ref.update(_j(np.arange(4)), _j(x), _j(k))
    for name in ("hi", "lo", "total"):
        _assert_bits(getattr(port, name), getattr(ref, name), name)
    # tenant 0 held -0.0 and met +0.0, tenant 1 the other way round
    assert not np.signbit(port.hi.numpy()[0, 0]) and np.signbit(port.lo.numpy()[1])
    assert np.isnan(port.hi.numpy()[2:4]).all() and np.isnan(port.lo.numpy()[2:4]).all()
    assert np.isneginf(port.hi.numpy()[4]).all() and np.isposinf(port.lo.numpy()[4])
    _assert_bits(port.compute(), ref.compute(), "compute")
    assert _common.dispatch_count("segment_merge", "torch") == 2


class _JSmallLeaves(J.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("s", jnp.zeros((2,), jnp.bfloat16), dist_reduce_fx="sum")
        self.add_state("c8", jnp.asarray(0, jnp.int8), dist_reduce_fx="sum")
        self.add_state("hi16", jnp.asarray(-(2**15), jnp.int16), dist_reduce_fx="max")
        self.add_state("lo8", jnp.asarray(127, jnp.int8), dist_reduce_fx="min")
        self.add_state("hib", jnp.asarray(-jnp.inf, jnp.bfloat16), dist_reduce_fx="max")

    def update(self, x, z, k):
        self.s = self.s + jnp.stack([x.sum(), (2 * x).sum()])
        self.c8 = self.c8 + k.sum().astype(jnp.int8)
        self.hi16 = jnp.maximum(self.hi16, k.max())
        self.lo8 = jnp.minimum(self.lo8, k.min().astype(jnp.int8))
        self.hib = jnp.maximum(self.hib, z.max())

    def compute(self):
        return self.s[0].astype(jnp.float32) + self.hib.astype(jnp.float32)


class _JMergedBeside(J.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("n", jnp.asarray(0, jnp.int32), dist_reduce_fx="sum")
        self.add_state("z32", jnp.asarray(-jnp.inf, jnp.float32), dist_reduce_fx="max")

    def update(self, x, z, k):
        self.n = self.n + (k != 0).sum(dtype=jnp.int32)
        self.z32 = jnp.maximum(self.z32, z.astype(jnp.float32).max())

    def compute(self):
        return self.z32 + self.n


def _small_leaf_batches(rows=24, steps=3, capacity=8):
    """Integer-valued bfloat16 sums (exact in bfloat16 as in float32), a
    bfloat16 max over NaN, +0.0, -0.0 and negatives, int16 values that fit
    int8 (whose int8 sums wrap); ids over the padding band [5, capacity) and outside the capacity,
    tenant 3 never routed. First, tenants 0 and 1 hold one signed zero and
    meet the other, tenants 2 and 4 meet a NaN."""
    k = np.asarray([7, -3, 100, -100], np.int16)
    ids = np.asarray([0, 1, 2, 4])
    yield ids, np.ones(4, np.float32), np.asarray([-0.0, 0.0, np.nan, -1.0], np.float32), k
    yield ids, -np.ones(4, np.float32), np.asarray([0.0, -0.0, -1.0, np.nan], np.float32), -k
    rng = np.random.RandomState(24)
    for _ in range(steps):
        ids = rng.randint(-2, capacity + 2, rows)
        ids[ids == 3] = -1
        x = rng.randint(-4, 5, rows).astype(np.float32)
        z = rng.choice(np.asarray([0.0, -0.0, -1.0, -0.5], np.float32), rows)
        z[rng.rand(rows) < 0.06] = np.nan
        k = rng.randint(-120, 121, rows).astype(np.int16)
        yield ids, x, z, k


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "compiled"])
@pytest.mark.parametrize("collection", [False, True], ids=["KeyedMetric", "MultiTenantCollection"])
def test_bfloat16_and_small_integer_leaves_take_the_merge_as_the_jax_package(collection, compiled):
    """bfloat16 sums added in float32, a wrapping int8 sum, int16/int8
    extrema and a bfloat16 max meeting NaN and both signed zeros key as the
    JAX package keys them, bit for bit, through the merge: one merge
    dispatch an update, alone or beside a second bundle's int32/float32
    leaves, and no B3, B4 or plain dispatch."""
    kw = dict(validate_ids=False, capacity=8)
    if collection:
        port = T.MultiTenantCollection({"small": SmallLeaves(**CPU), "merged": MergedBeside(**CPU)}, 5, **kw, **CPU)
        ref = J.MultiTenantCollection({"small": _JSmallLeaves(), "merged": _JMergedBeside()}, 5, **kw)
    else:
        port, ref = T.KeyedMetric(SmallLeaves(**CPU), 5, **kw, **CPU), J.KeyedMetric(_JSmallLeaves(), 5, **kw)
    batches = list(_small_leaf_batches())
    bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    if compiled:
        ids, x, z, k = batches[0]
        port.warmup(_t(ids), bf16(x), bf16(z), _t(k))
    _common.reset_dispatch_counters()
    for ids, x, z, k in batches:
        port.update(_t(ids), bf16(x), bf16(z), _t(k))
        ref.update(_j(ids), jnp.asarray(x, jnp.bfloat16), jnp.asarray(z, jnp.bfloat16), _j(k))
    pairs = ([(port._keyed[o], ref._keyed[o]) for o in ref._keyed] if collection else [(port, ref)])
    for km, jm in pairs:
        for name in jm._child._defaults:
            got, want = getattr(km, name), np.asarray(getattr(jm, name))
            assert got.dtype == km._child._defaults[name].dtype and tuple(got.shape) == want.shape, name
            if got.dtype == torch.bfloat16:
                got, want = got.float(), want.astype(np.float32)
            _assert_bits(got, want, name)
    small = port._keyed["small"] if collection else port
    # tenant 0 held -0.0 and met +0.0, tenant 1 the other way round; 2 and 4 met a NaN
    assert float(small.hib[0]) == 0 and not torch.signbit(small.hib[:2]).any()
    assert torch.isnan(small.hib[[2, 4]]).all() and float(small.hib[3]) == -np.inf and int(small.lo8[3]) == 127
    assert int(small.c8[1]) == -198 + 256 and int(small.c8[2]) == 146 - 256  # the int8 sums wrapped
    assert _common.dispatch_count("segment_merge", "torch") == len(batches)
    for op in ("add", "max", "min"):
        for path in ("torch", "plain"):
            assert _common.dispatch_count(f"segment_scatter_{op}", path) == 0, (op, path)


def test_regression_collection_matches_jax_and_the_hooks_key_it():
    members = lambda pkg, **d: [pkg.MeanSquaredError(**d), pkg.MeanAbsoluteError(**d),  # noqa: E731
                                pkg.PearsonCorrcoef(streaming=True, **d)]
    port = T.MetricCollection(members(T, **CPU)).keyed(10)
    ref = J.MetricCollection(members(J)).keyed(10)
    assert isinstance(port, T.MultiTenantCollection) and port.device == torch.device("cpu")
    rng = np.random.RandomState(13)
    for step in range(4):
        ids = rng.randint(0, 10, 64)
        p = rng.rand(64).astype(np.float32)
        t = (p * 0.9 + 0.1 * rng.rand(64)).astype(np.float32)
        port.update(_t(ids), _t(p), _t(t))
        ref.update(_j(ids), _j(p), _j(t))
        if step == 1:
            port.reset(tenant_ids=_t([2, 7]))
            ref.reset(tenant_ids=_j([2, 7]))
    assert port.state_bundles == 3
    for owner, km in port._keyed.items():
        _assert_float_states(km, ref._keyed[owner], rtol=1e-6)
    got, want = port.compute(), ref.compute()
    for name, value in want.items():
        tol = 1e-12 if got[name].dtype == torch.float64 else 1e-6
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value), rtol=tol, atol=tol, equal_nan=True)
    # one merge launch (on the card) an update over the three bundles' float32/int32 leaves,
    # and each bundle's one plain scatter of its float64/int64 leaves
    assert _common.dispatch_count("segment_merge", "torch") == 4
    assert _common.dispatch_count("segment_scatter_add", "torch") == 0
    assert _common.dispatch_count("segment_scatter_add", "plain") == 12
    keyed = T.MeanSquaredError(**CPU).keyed(3, validate_ids=False)
    assert isinstance(keyed, T.KeyedMetric) and keyed.num_tenants == 3 and not keyed.validate_ids
