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
from metrics_tpu.utilities.stacked import row_states as jax_row_states
from metrics_tpu_torch.kernels import _common
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities import checks
from metrics_tpu_torch.utilities.convert import load_numpy_states
from metrics_tpu_torch.utilities.stacked import broadcast_stack, row_states, stack_pytrees, vmap_update
from metrics_tpu_torch.wrappers.multitenant import _pow2_at_least

NC = 4
C = 10
CPU = {"device": "cpu"}


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
    assert _common.dispatch_count("segment_scatter_add", "torch") == 3 * 2
    assert _common.dispatch_count("segment_scatter_max", "torch") == 3
    assert _common.dispatch_count("stat_scores_counts", "torch") == 0  # per-row terms under vmap
    for op in ("segment_scatter_add", "segment_scatter_max", "stat_scores_counts"):
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


class _Int64Sum(_MeanState):
    def __init__(self, **kw):
        Metric.__init__(self, **kw)
        self.add_state("x", torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")


class _NoStates(_MeanState):
    def __init__(self, **kw):
        Metric.__init__(self, **kw)


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: T.StatScores(reduce="samples", **CPU), "unbounded list states"),
        (lambda: _MeanState(**CPU), "reductions the segment router cannot route"),
        (lambda: _Int64Sum(**CPU), "dtypes the segment-scatter kernels cannot"),
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
    # only the rows' own updates (with macro counts) ran the count pass
    assert _common.dispatch_count("stat_scores_counts", "torch") == (len(target) if child.reduce == "macro" else 0)


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


@pytest.mark.cuda
def test_keyed_collection_on_the_card_matches_the_cpu(cuda_device):
    rng = np.random.RandomState(10)
    card = T.MultiTenantCollection(_members(T, device=cuda_device), 50, validate_ids=False, device=cuda_device)
    host = T.MultiTenantCollection(_members(T, **CPU), 50, validate_ids=False, **CPU)
    for _ in range(3):
        ids = rng.randint(-1, 51, 256)
        preds, target = _probs_batch(rng, rows=256, c=C)
        card.update(_t(ids).to(cuda_device), _t(preds).to(cuda_device), _t(target).to(cuda_device))
        host.update(_t(ids), _t(preds), _t(target))
    assert _common.launch_count("segment_scatter_add") == 6 and _common.launch_count("segment_scatter_max") == 3
    assert _common.launch_count("stat_scores_counts") == 0
    for owner, km in host._keyed.items():
        for name, value in km._get_states().items():
            assert torch.equal(getattr(card._keyed[owner], name).cpu(), value)
    got, want = card.compute(), host.compute()
    for name in want:
        torch.testing.assert_close(got[name].cpu(), want[name], rtol=1e-6, atol=1e-7, equal_nan=True)
