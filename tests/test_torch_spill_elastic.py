"""The cold-tenant spiller and the elastic tenant axis against the JAX
package.

Counterparts of ``tests/durability/test_spill.py`` and ``test_elastic.py``:
the same seeded batches, evictions and resizes on a JAX keyed object and the
port's; the integer states, per-tenant values (NaN where a tenant never had
a row), occupancy reports, capacities and ledgers are compared exactly.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as T
from metrics_tpu.durability import TenantSpiller as JSpiller
from metrics_tpu_torch.durability import CheckpointManager, TenantSpiller
from metrics_tpu_torch.observability.memory import LEDGER

N = 32
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _no_tracked_owner_outlives_a_test():
    """A spiller tracks its metric in its package's memory ledger; later
    tests in this process read the ledgers' owner counts, so every owner a
    test leaves tracked is dropped after it."""
    from metrics_tpu.observability.memory import LEDGER as JLEDGER

    before = {id(ledger): set(ledger._entries) for ledger in (JLEDGER, LEDGER)}
    yield
    gc.collect()
    for ledger in (JLEDGER, LEDGER):
        for oid in set(ledger._entries) - before[id(ledger)]:
            ledger._evict_entry(oid)


def _pair(n=N, collection=False):
    if collection:
        kw = dict(average="macro", num_classes=3)
        return (J.MultiTenantCollection({"acc": J.Accuracy(), "prec": J.Precision(**kw)}, n, validate_ids=False),
                T.MultiTenantCollection({"acc": T.Accuracy(**CPU), "prec": T.Precision(**kw, **CPU)}, n,
                                        validate_ids=False, **CPU))
    return (J.KeyedMetric(J.Accuracy(), n, validate_ids=False),
            T.KeyedMetric(T.Accuracy(**CPU), n, validate_ids=False, **CPU))


def _batch(rng, rows, n=N, collection=False):
    ids = rng.randint(0, n, rows)
    if collection:
        x = rng.rand(rows, 3).astype(np.float32)
        return ids, x / x.sum(-1, keepdims=True), rng.randint(0, 3, rows)
    return ids, rng.rand(rows).astype(np.float32), rng.randint(0, 2, rows)


def _update(objs, batch):
    objs[0].update(*[jnp.asarray(a) for a in batch])
    objs[1].update(*[torch.as_tensor(a) for a in batch])


def _values_equal(j, t):
    if isinstance(j, dict):
        for k in j:
            _values_equal(j[k], t[k])
        return
    j, t = np.asarray(j, np.float64), t.numpy().astype(np.float64)
    np.testing.assert_array_equal(np.isnan(j), np.isnan(t))
    np.testing.assert_allclose(t[~np.isnan(t)], j[~np.isnan(j)], rtol=1e-6)


def _states(obj):
    bundles = obj._keyed if getattr(obj, "_keyed", None) is not None else {"": obj}
    return {(o, n): np.asarray(v) for o, km in bundles.items() for n, v in km._get_states().items()}


def _states_equal(j, t):
    js, ts = _states(j), _states(t)
    assert set(js) == set(ts)
    for key in js:
        np.testing.assert_array_equal(ts[key], js[key].astype(ts[key].dtype), err_msg=str(key))


@pytest.mark.parametrize("collection", [False, True])
def test_evict_and_fault_back_equal_the_jax_package(collection):
    objs = _pair(collection=collection)
    rng = np.random.RandomState(0)
    _update(objs, _batch(rng, 200, collection=collection))
    spillers = (JSpiller(objs[0], resident_cap=4, auto=False), TenantSpiller(objs[1], resident_cap=4, auto=False))
    victims = np.arange(0, N, 3)
    assert spillers[0].evict(victims) == spillers[1].evict(victims)
    reports = [sp.occupancy() for sp in spillers]
    assert reports[0]["spilled"] == reports[1]["spilled"] and reports[0]["active"] == reports[1]["active"]
    assert reports[1]["spilled_bytes"] == sum(r.nbytes for e in spillers[1]._spilled.values()
                                              for leaves in e.values() for r in leaves.values())
    # evicted rows read the defaults on the device, as the JAX package's do
    _states_equal(*objs)
    # an update naming spilled tenants faults them back first
    _update(objs, _batch(rng, 64, collection=collection))
    _states_equal(*objs)
    assert spillers[1].fault_back(np.arange(N)) == spillers[0].fault_back(np.arange(N))
    _values_equal(objs[0].compute(), objs[1].compute())
    assert spillers[1].report()["conservation_ok"] and spillers[1].report()["spilled"] == 0


def test_reads_after_a_spill_are_bit_identical_to_a_never_evicted_control():
    rng_a, rng_b = np.random.RandomState(0), np.random.RandomState(0)
    m = T.KeyedMetric(T.Accuracy(**CPU), 64, validate_ids=False, **CPU)
    control = T.KeyedMetric(T.Accuracy(**CPU), 64, validate_ids=False, **CPU)
    for metric, rng in ((m, rng_a), (control, rng_b)):
        metric.update(*map(torch.as_tensor, _batch(rng, 256, 64)))
    sp = TenantSpiller(m, resident_cap=8, auto=True)
    assert sp.maybe_evict() == sp.occupancy()["active"] - 8
    for metric, rng in ((m, rng_a), (control, rng_b)):
        for _ in range(3):
            metric.update(*map(torch.as_tensor, _batch(rng, 32, 64)))
    report = sp.report()
    assert report["conservation_ok"] and report["resident_under_cap"]
    got, want = m.compute(), control.compute()
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got[~want.isnan()], want[~want.isnan()])
    assert sp.report()["spilled"] == 0


def test_the_memory_ledger_follows_the_spilled_bytes():
    m = T.KeyedMetric(T.Accuracy(**CPU), 16, validate_ids=False, **CPU)
    m.update(torch.arange(16), torch.full((16,), 0.7), torch.ones(16, dtype=torch.int64))
    sp = TenantSpiller(m, resident_cap=2, auto=False)
    sp.maybe_evict()
    entry = LEDGER.report()["owners"][m.telemetry_key]
    assert entry["spilled_bytes"] == sp.occupancy()["spilled_bytes"] == 14 * 7 * 4
    sp.detach()
    assert LEDGER.report()["owners"][m.telemetry_key]["spilled_bytes"] == 0
    assert "_durability_hooks" not in m.__dict__


def test_a_spiller_refuses_a_second_one_and_bad_arguments():
    m = T.KeyedMetric(T.Accuracy(**CPU), 4, **CPU)
    with pytest.raises(ValueError, match="resident_cap"):
        TenantSpiller(m, resident_cap=0)
    sp = TenantSpiller(m, resident_cap=1)
    with pytest.raises(ValueError, match="already has durability hooks"):
        TenantSpiller(m, resident_cap=1)
    sp.detach()


def test_a_restore_drops_the_spilled_rows(tmp_path):
    m = T.KeyedMetric(T.Accuracy(**CPU), 16, validate_ids=False, **CPU)
    m.update(torch.arange(16), torch.full((16,), 0.7), torch.ones(16, dtype=torch.int64))
    mgr = CheckpointManager(str(tmp_path), m)
    mgr.save()
    saved = m.tp.clone()
    sp = TenantSpiller(m, resident_cap=4, auto=False)
    sp.maybe_evict()
    m.update(torch.tensor([0]), torch.tensor([0.7]), torch.tensor([1]))
    mgr.restore()
    assert sp.occupancy()["spilled"] == 0 and torch.equal(m.tp, saved)
    assert sp.occupancy()["active"] == 16


def test_pickling_faults_back_and_drops_the_hooks():
    m = T.KeyedMetric(T.Accuracy(**CPU), 8, validate_ids=False, **CPU)
    m.update(torch.arange(8), torch.full((8,), 0.7), torch.ones(8, dtype=torch.int64))
    sp = TenantSpiller(m, resident_cap=2, auto=False)
    sp.maybe_evict()
    clone = m.clone()
    assert sp.occupancy()["spilled"] == 0 and "_durability_hooks" not in clone.__dict__
    assert torch.equal(clone.tp, torch.ones(8, dtype=torch.int32))


# -- the elastic tenant axis -------------------------------------------------------------


@pytest.mark.parametrize("collection", [False, True])
def test_grow_and_compact_equal_the_jax_package(collection):
    objs = _pair(8, collection=collection)
    rng = np.random.RandomState(4)
    _update(objs, _batch(rng, 40, 8, collection))
    caps = []
    for step in ("grow", "update", "compact_auto", "update", "compact", "grow_noop", "compact_same"):
        if step == "grow":
            caps.append((objs[0].grow(20), objs[1].grow(20)))
        elif step == "update":
            _update(objs, _batch(rng, 40, 20 if objs[1].num_tenants == 20 else objs[1].num_tenants, collection))
        elif step == "compact_auto":
            caps.append((objs[0].compact(), objs[1].compact()))
        elif step == "compact":
            caps.append((objs[0].compact(5), objs[1].compact(5)))
        elif step == "grow_noop":
            caps.append((objs[0].grow(3), objs[1].grow(3)))
        else:
            caps.append((objs[0].compact(5), objs[1].compact(5)))
        assert objs[0].num_tenants == objs[1].num_tenants and objs[0].capacity == objs[1].capacity
        _states_equal(*objs)
        _values_equal(objs[0].compute(), objs[1].compute())
    assert [c[0] for c in caps] == [c[1] for c in caps]
    jr, tr = objs[0]._traffic.arrays()[0], objs[1]._traffic.arrays()[0]
    np.testing.assert_array_equal(jr, tr)
    with pytest.raises(ValueError, match="grow"):
        objs[1].compact(99)


def test_a_shrink_within_one_capacity_resets_the_band_in_place():
    m = T.KeyedMetric(T.Accuracy(**CPU), 6, capacity=8, validate_ids=False, **CPU)
    m.update(torch.arange(6), torch.full((6,), 0.7), torch.ones(6, dtype=torch.int64))
    before = m.tp
    assert m.compact(3) == 4
    m2 = T.KeyedMetric(T.Accuracy(**CPU), 7, capacity=8, validate_ids=False, **CPU)
    m2.update(torch.arange(7), torch.full((7,), 0.7), torch.ones(7, dtype=torch.int64))
    held = m2.tp
    m2._resize(3, 8)  # same capacity: rows 3..6 reset under the tensor a graph would hold
    assert m2.tp is held and held.tolist() == [1, 1, 1, 0, 0, 0, 0, 0]
    assert before.shape == (8,) and m.tp.shape == (4,)


def test_the_compiled_keyed_update_lands_on_a_new_key_per_capacity():
    m = T.KeyedMetric(T.Accuracy(**CPU), 10, validate_ids=False, **CPU)
    eager = T.KeyedMetric(T.Accuracy(**CPU), 10, validate_ids=False, **CPU)
    rng = np.random.RandomState(2)
    batch = _batch(rng, 16, 10)
    m.warmup(*map(torch.as_tensor, batch))
    for obj in (m, eager):
        obj.update(*map(torch.as_tensor, batch))
        obj.grow(40)
        obj.update(*map(torch.as_tensor, _batch(np.random.RandomState(3), 16, 40)))
        obj.compact(10)
        obj.update(*map(torch.as_tensor, batch))
        obj.grow(40)
        obj.update(*map(torch.as_tensor, batch))
    _states_equal(eager, m)
    fn = m.__dict__["_keyed_update_fn"] or m.__dict__["_keyed_update_copy_fn"]
    assert fn._cache_size() == 3  # capacities 10, 64 and 16: one key each, the return to 64 replays


def test_the_scheduler_prunes_the_generations_of_compacted_tenants():
    from metrics_tpu.serving import SLOScheduler as JScheduler

    outs = []
    for make, metric in ((lambda m: JScheduler(m, start=False), J.KeyedMetric(J.Accuracy(), 16, validate_ids=False)),
                         (lambda m: T.SLOScheduler(m, start=False, **CPU),
                          T.KeyedMetric(T.Accuracy(**CPU), 16, validate_ids=False, **CPU))):
        svc = make(metric)
        svc.submit_many(np.array([1, 9, 14]), np.ones(3, np.float32), np.ones(3, np.int32))
        svc.queue.flush()
        before = svc.tenant_generations()
        metric.compact(8)
        dropped = svc.prune_tenant_generations()
        outs.append((before, dropped, svc.tenant_generations(), svc.prune_tenant_generations()))
        svc.close()
    assert outs[0] == outs[1] and outs[1][1] == 2 and outs[1][2] == {1: 1}


def test_a_durability_pin_feeds_the_ledger_with_telemetry_off(tmp_path):
    from metrics_tpu_torch import observability as tobs

    m = T.KeyedMetric(T.Accuracy(**CPU), 8, validate_ids=False, **CPU)
    tobs.disable()
    try:
        m.update(torch.tensor([1]), torch.tensor([0.9]), torch.tensor([1]))
        assert m._traffic.arrays()[0] is None
        mgr = CheckpointManager(str(tmp_path), m)
        m.update(torch.tensor([2, 3]), torch.tensor([0.9, 0.9]), torch.tensor([1, 1]))
        assert m._traffic.arrays()[0].tolist() == [0, 0, 1, 1, 0, 0, 0, 0]
        mgr.save()
        m.update(torch.tensor([5]), torch.tensor([0.9]), torch.tensor([1]))
        assert mgr.save()["tenants"] == [5]
    finally:
        tobs.enable()
    assert m.__dict__["_durability_traffic_pin"] == 1
    del mgr
    import gc

    gc.collect()
    assert "_durability_traffic_pin" not in m.__dict__


def test_resize_telemetry_equals_the_jax_package():
    from metrics_tpu import observability as jobs
    from metrics_tpu_torch import observability as tobs

    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
    objs = _pair(8)
    for obj in objs:
        obj.grow(20)
        obj.compact(4)
    import metrics_tpu.durability  # noqa: F401 - the JAX section appears once its plane is imported

    j, t = jobs.snapshot()["durability"], tobs.snapshot()["durability"]
    assert {k: j[k] for k in ("grows", "compactions")} == {k: t[k] for k in ("grows", "compactions")} == {
        "grows": 1, "compactions": 1}
    jev = [e.payload for e in jobs.EVENTS.events() if e.kind == "durability"]
    tev = [e.payload for e in tobs.EVENTS.events() if e.kind == "durability"]
    assert jev == tev
