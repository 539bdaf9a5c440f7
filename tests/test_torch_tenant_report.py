"""The keyed wrappers' serial lock, tenant ledger and ``tenant_report`` against the JAX package's.

The same seeded numpy batches go through the JAX ``KeyedMetric`` /
``MultiTenantCollection`` and the port's (``device="cpu"``); the reports
must be equal once their clock-valued fields (``staleness_s``,
``stalest``' ages, ``generated_unix_s``) are masked, and their snapshot
blobs, Prometheus series and events must agree. The port's ledger, fed
the kernels' per-tenant row counts (``_TenantTraffic.note``), is driven
here with the plain version's counts on the CPU and must read the same
arrays as the JAX ledger fed the ids. Threaded
cases (writers and report readers on one wrapper) must lose no row and end
in the JAX package's integer states.
"""
import copy
import json
import pickle
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.observability as jobs
from metrics_tpu.wrappers.multitenant import _TenantTraffic as JTenantTraffic
import metrics_tpu_torch as T
import metrics_tpu_torch.observability as tobs
from metrics_tpu_torch.kernels.segment_scatter import segment_scatter_add_torch
from metrics_tpu_torch.serving.staging import as_staged
from metrics_tpu_torch.utilities.convert import load_tenant_traffic
from metrics_tpu_torch.wrappers.multitenant import _TenantTraffic

CPU = {"device": "cpu"}
NC = 3


@pytest.fixture(autouse=True)
def clean():
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
    yield
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()


def _batch(rows, n_tenants, seed=0, ids=None):
    rng = np.random.RandomState(seed)
    if ids is None:
        ids = rng.randint(0, n_tenants, rows)
    probs = rng.rand(rows, NC).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    return np.asarray(ids), probs, rng.randint(0, NC, rows)


def _pair(n, members=False, **kw):
    if members:
        jm = J.MultiTenantCollection(
            [J.Accuracy(), J.Precision(average="macro", num_classes=NC), J.Recall(average="macro", num_classes=NC),
             J.F1(average="macro", num_classes=NC)], n, **kw)
        tm = T.MultiTenantCollection(
            [T.Accuracy(**CPU), T.Precision(average="macro", num_classes=NC, **CPU),
             T.Recall(average="macro", num_classes=NC, **CPU), T.F1(average="macro", num_classes=NC, **CPU)],
            n, **kw, **CPU)
        return jm, tm
    return J.KeyedMetric(J.Accuracy(), n, **kw), T.KeyedMetric(T.Accuracy(**CPU), n, **kw, **CPU)


def _update(jm, tm, ids, probs, target):
    jm.update(jnp.asarray(ids), jnp.asarray(probs), jnp.asarray(target))
    tm.update(torch.from_numpy(ids), torch.from_numpy(probs), torch.from_numpy(target))


def _masked(rep):
    rep = dict(rep)
    rep.pop("generated_unix_s")
    rep["staleness_s"] = {k: (v is None) for k, v in rep["staleness_s"].items()}
    rep["stalest"] = sorted(t["tenant"] for t in rep["stalest"])
    return rep


@pytest.mark.parametrize("top_k", [0, 2, 5, 50])
def test_keyed_report_occupancy_and_topk_traffic(top_k):
    jm, tm = _pair(10)
    ids, probs, target = _batch(7, 10, ids=np.array([3, 3, 3, 3, 7, 7, 0]))
    _update(jm, tm, ids, probs, target)
    rep = tm.tenant_report(top_k=top_k)
    assert _masked(rep) == _masked(jm.tenant_report(top_k=top_k))
    assert rep["tenants"] == 10 and rep["rows_routed"] == 7 and rep["tracking"] is True
    assert rep["occupancy"] == {"active": 3, "fraction": 0.3}
    if top_k == 2:
        assert rep["top_traffic"] == [{"tenant": 3, "rows": 4}, {"tenant": 7, "rows": 2}]
    json.dumps(rep)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keyed_report_accumulates_across_updates(seed):
    jm, tm = _pair(4)
    for step in range(3):
        _update(jm, tm, *_batch(8, 4, seed=seed * 10 + step))
    rep = tm.tenant_report()
    assert _masked(rep) == _masked(jm.tenant_report())
    assert rep["rows_routed"] == 24
    rows, _ = tm._traffic.arrays()
    np.testing.assert_array_equal(rows, jm._traffic.arrays()[0])
    for name, value in tm._get_states().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(jm, name)))


def test_keyed_report_staleness_orders_tenants():
    tm = T.KeyedMetric(T.Accuracy(**CPU), 5, **CPU)
    ids, probs, target = _batch(2, 5, ids=np.array([0, 1]))
    tm.update(torch.from_numpy(ids), torch.from_numpy(probs), torch.from_numpy(target))
    time.sleep(0.05)
    ids, probs, target = _batch(2, 5, seed=1, ids=np.array([2, 2]))
    tm.update(torch.from_numpy(ids), torch.from_numpy(probs), torch.from_numpy(target))
    st = tm.tenant_report(top_k=5)["staleness_s"]
    rep = tm.tenant_report(top_k=5)
    assert st["max"] >= st["p95"] >= st["p50"] >= 0 and st["max"] >= 0.05
    assert {t["tenant"] for t in rep["stalest"][:2]} == {0, 1}
    assert rep["stalest"][-1]["tenant"] == 2


@pytest.mark.parametrize("members", [False, True])
def test_report_counts_the_invalid_rate_in_clip_mode(members):
    jm, tm = _pair(4, members=members, validate_ids=False)
    _update(jm, tm, *_batch(8, 4, ids=np.array([0, 1, 2, 3, -1, 7, 9, 2])))
    rep = tm.tenant_report()
    assert rep["rows_routed"] == 5 and rep["invalid_tenant_ids"] == 3
    assert rep["invalid_rate"] == pytest.approx(3 / 8)
    jrep = jm.tenant_report()
    if jrep["invalid_tenant_ids"]:  # the JAX backend ran its debug callback
        assert _masked(rep) == _masked(jrep)


def test_keyed_reset_clears_the_ledger():
    jm, tm = _pair(4)
    _update(jm, tm, *_batch(8, 4))
    jm.reset(jnp.asarray([0]))
    tm.reset(torch.tensor([0]))
    rep = tm.tenant_report()
    assert _masked(rep) == _masked(jm.tenant_report())
    assert all(t["tenant"] != 0 for t in rep["top_traffic"])
    jm.reset()
    tm.reset()
    rep = tm.tenant_report()
    assert _masked(rep) == _masked(jm.tenant_report())
    assert rep["rows_routed"] == 0 and rep["tracking"] is False and rep["top_traffic"] == []
    assert rep["staleness_s"] == {"p50": None, "p95": None, "max": None}


def test_collection_report_covers_members_and_bundles():
    jm, tm = _pair(6, members=True)
    for seed in range(2):
        _update(jm, tm, *_batch(12, 6, seed=seed))
    rep = tm.tenant_report(top_k=3)
    assert _masked(rep) == _masked(jm.tenant_report(top_k=3))
    assert rep["metric"] == "MultiTenantCollection" and rep["members"] == 4
    assert rep["state_bundles"] == tm.state_bundles == 2 and rep["rows_routed"] == 24
    tm.reset(np.array([1, 2]))
    jm.reset(np.array([1, 2]))
    assert _masked(tm.tenant_report()) == _masked(jm.tenant_report())


def test_report_lands_on_snapshot_prometheus_and_timeline():
    jm, tm = _pair(8)
    _update(jm, tm, *_batch(16, 8))
    tm.tenant_report()
    jm.tenant_report()
    tsnap, jsnap = tobs.snapshot(), jobs.snapshot()
    blob = tsnap["metrics"][tm.telemetry_key]["info"]["tenant_report"]
    assert blob == jsnap["metrics"][jm.telemetry_key]["info"]["tenant_report"]
    assert set(blob) == {"tenants", "rows_routed", "occupancy", "invalid_rate"}
    key = tm.telemetry_key
    text = tobs.render_prometheus(tsnap)
    assert f'metrics_tpu_tenants{{metric="{key}"}} 8' in text
    assert f'metrics_tpu_tenant_rows_routed_total{{metric="{key}"}} 16' in text
    assert f'metrics_tpu_tenants_active{{metric="{key}"}} {blob["occupancy"]["active"]}' in text
    assert "metrics_tpu_tenant_invalid_rate" in text
    tevents = [(e.kind, e.payload) for e in tobs.EVENTS.events() if e.kind == "tenant_report"]
    jevents = [(e.kind, e.payload) for e in jobs.EVENTS.events() if e.kind == "tenant_report"]
    assert tevents == jevents and len(tevents) == 1


def test_telemetry_off_records_no_traffic():
    tobs.disable()
    tm = T.KeyedMetric(T.Accuracy(**CPU), 4, **CPU)
    ids, probs, target = _batch(8, 4)
    tm.update(torch.from_numpy(ids), torch.from_numpy(probs), torch.from_numpy(target))
    assert tm._traffic.rows is None
    rep = tm.tenant_report()
    assert rep["tracking"] is False and rep["rows_routed"] == 0
    tobs.enable()


# ---------------------------------------------------------------------------
# the ledger's two forms
# ---------------------------------------------------------------------------


def _counts(ids, capacity, dtype=torch.int64):
    """The per-tenant row counts the segment scatter returns for ``ids``."""
    rows = torch.zeros((len(ids), 1))
    return segment_scatter_add_torch(rows, torch.from_numpy(np.asarray(ids)).to(dtype), capacity)[1]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_counts_fed_ledger_reads_the_jax_ledgers_arrays(seed, dtype):
    """The port's ledger, fed the kernels' per-tenant counts (added in, one
    read at report time), against the JAX ledger fed the ids on the host,
    on the same batches with invalid ids among them, a padded capacity too;
    driven with the plain version's counts on the CPU."""
    rng = np.random.RandomState(seed)
    jax_ledger, ledger = JTenantTraffic(12), _TenantTraffic(12)
    for _ in range(4):
        ids = rng.randint(-3, 18, 50)
        jax_ledger.note(ids)
        ledger.note(_counts(ids, 16, dtype))
    assert ledger.rows.shape == (12,) and ledger.last_seen.dtype == torch.float64
    (jr, js), (tr, ts) = jax_ledger.arrays(), ledger.arrays()
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    assert tr.dtype == np.int64 and ts.dtype == np.float64
    assert _masked(ledger.report(5, 7)) == _masked(jax_ledger.report(5, 7))


def test_a_ledger_fed_only_invalid_ids_tracks_with_no_rows():
    """The one reading that differs from the JAX ledger: it learns whether a
    row was valid from the counts on the update's device, so it starts
    tracking at the first update, where the JAX ledger waits for a valid id
    (``tracking`` is ``True`` here, ``False`` there; no row either way)."""
    jm, tm = _pair(4, validate_ids=False)
    _update(jm, tm, *_batch(3, 4, ids=np.array([-1, 4, 9])))
    jrep, trep = jm.tenant_report(), tm.tenant_report()
    assert jrep["tracking"] is False and trep["tracking"] is True
    jrep["tracking"] = True
    assert _masked(trep) == _masked(jrep) and trep["rows_routed"] == 0 and trep["invalid_tenant_ids"] == 3


def test_ledger_notes_stamps_and_clears():
    ledger = _TenantTraffic(6)
    assert ledger.arrays() == (None, None)
    ledger.note(_counts([0, 1, 1], 6))
    first = ledger.arrays()[1][0]
    time.sleep(0.01)
    ledger.note(_counts([1, 5, 9], 6))
    rows, seen = ledger.arrays()
    np.testing.assert_array_equal(rows, [1, 3, 0, 0, 0, 1])
    assert seen[0] == first and seen[1] > first and np.isnan(seen[2])
    ledger.clear(torch.tensor([1]))
    rows, seen = ledger.arrays()
    np.testing.assert_array_equal(rows, [1, 0, 0, 0, 0, 1])
    assert np.isnan(seen[1])
    ledger.clear()
    assert ledger.arrays() == (None, None)


def test_a_staged_view_dispatches_its_twin_and_feeds_the_ledger():
    tm = T.KeyedMetric(T.Accuracy(**CPU), 6, validate_ids=False, **CPU)
    ref = T.KeyedMetric(T.Accuracy(**CPU), 6, validate_ids=False, **CPU)
    ids, probs, target = _batch(10, 6)
    ids[3] = -1
    host_ids = ids.astype(np.int32)
    staged = [as_staged(h, torch.from_numpy(h).clone()) for h in (host_ids, probs, target)]
    tm.update(*staged)
    ref.update(torch.from_numpy(ids), torch.from_numpy(probs), torch.from_numpy(target))
    for name, value in tm._get_states().items():
        assert torch.equal(value, getattr(ref, name))
    assert tm._traffic.rows.device == tm.device
    np.testing.assert_array_equal(tm._traffic.arrays()[0], ref._traffic.arrays()[0])
    assert tm.tenant_report()["rows_routed"] == 9 and tm.tenant_report()["invalid_tenant_ids"] == 1


def test_a_staged_view_is_validated_on_the_host():
    tm = T.KeyedMetric(T.Accuracy(**CPU), 4, **CPU)
    ids = np.array([0, 5], np.int32)
    probs, target = np.array([0.2, 0.7], np.float32), np.array([0, 1])
    staged = [as_staged(h, torch.from_numpy(h).clone()) for h in (ids, probs, target)]
    with pytest.raises(ValueError, match="first offender: index 1 = 5"):
        tm.update(*staged)


def test_load_tenant_traffic_carries_the_jax_ledger_across():
    jm, _ = _pair(6)
    ids, probs, target = _batch(20, 6)
    jm.update(jnp.asarray(ids), jnp.asarray(probs), jnp.asarray(target))
    tm = T.KeyedMetric(T.Accuracy(**CPU), 6, **CPU)
    load_tenant_traffic(tm, *jm._traffic.arrays())
    assert _masked(tm.tenant_report()) == _masked(jm.tenant_report())
    load_tenant_traffic(tm, None, None)
    assert tm.tenant_report()["tracking"] is False
    with pytest.raises(ValueError, match="together"):
        load_tenant_traffic(tm, np.zeros(6), None)
    with pytest.raises(ValueError, match="6 tenants"):
        load_tenant_traffic(tm, np.zeros(5), np.zeros(5))


# ---------------------------------------------------------------------------
# the serial lock, pickling and cloning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("members", [False, True])
def test_the_serial_lock_is_lazy_process_local_and_dropped_on_copies(members):
    _, tm = _pair(5, members=members)
    lock = tm._serial_lock()
    assert tm._serial_lock() is lock and type(lock).__name__ == "RLock"
    tm.update(*map(torch.from_numpy, _batch(10, 5)))
    for copied in (pickle.loads(pickle.dumps(tm)), copy.deepcopy(tm)):
        assert "_ingest_lock" not in copied.__dict__
        assert copied._serial_lock() is not lock
        assert copied.tenant_report()["rows_routed"] == 10
        assert copied.telemetry_key != tm.telemetry_key


def test_report_survives_clone_and_the_clone_counts_on_its_own():
    tm = T.KeyedMetric(T.Accuracy(**CPU), 5, **CPU)
    tm.update(*map(torch.from_numpy, _batch(10, 5)))
    clone = tm.clone()
    clone.update(*map(torch.from_numpy, _batch(4, 5, seed=1)))
    assert tm.tenant_report()["rows_routed"] == 10 and clone.tenant_report()["rows_routed"] == 14
    np.testing.assert_array_equal(clone._traffic.arrays()[0] - tm._traffic.arrays()[0],
                                  np.bincount(_batch(4, 5, seed=1)[0], minlength=5))


N_TENANTS, WRITERS, BATCHES, ROWS = 32, 4, 12, 64


def _writer_batches(w):
    rng = np.random.RandomState(100 + w)
    return [(rng.randint(0, N_TENANTS, ROWS), rng.rand(ROWS).astype(np.float32), rng.randint(0, 2, ROWS))
            for _ in range(BATCHES)]


@pytest.mark.parametrize("members", [False, True])
def test_concurrent_updates_and_reports_lose_nothing(members):
    """Writer threads update one wrapper while readers call
    ``tenant_report()``: every report is internally consistent, no routed
    row is lost, and the final integer states equal the JAX package's on the
    same rows (sums do not depend on the threads' order)."""
    if members:
        tm = T.MultiTenantCollection([T.Accuracy(**CPU)], N_TENANTS, **CPU)
        jm = J.MultiTenantCollection([J.Accuracy()], N_TENANTS)
    else:
        tm = T.KeyedMetric(T.Accuracy(**CPU), N_TENANTS, **CPU)
        jm = J.KeyedMetric(J.Accuracy(), N_TENANTS)
    batches = {w: _writer_batches(w) for w in range(WRITERS)}
    errors, stop = [], threading.Event()

    def writer(w):
        try:
            for ids, preds, target in batches[w]:
                tm.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
        except Exception as err:  # noqa: BLE001 - asserted below
            errors.append(err)

    def reader():
        try:
            while not stop.is_set():
                rep = tm.tenant_report(top_k=5)
                assert rep["occupancy"]["active"] <= rep["tenants"]
                assert sum(t["rows"] for t in rep["top_traffic"]) <= rep["rows_routed"] <= WRITERS * BATCHES * ROWS
                time.sleep(0.002)  # a dashboard's pace, not a spin that starves the writers
        except Exception as err:  # noqa: BLE001 - asserted below
            errors.append(err)

    readers = [threading.Thread(target=reader) for _ in range(2)]
    writers = [threading.Thread(target=writer, args=(w,)) for w in range(WRITERS)]
    for t in readers + writers:
        t.start()
    for t in writers:
        t.join(timeout=60)
    stop.set()
    for t in readers:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in readers + writers) and not errors, errors
    assert tm.tenant_report()["rows_routed"] == WRITERS * BATCHES * ROWS
    for w in range(WRITERS):
        for ids, preds, target in batches[w]:
            jm.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_array_equal(tm._traffic.arrays()[0], np.asarray(jm._traffic.arrays()[0]))
    keyed_t = tm._keyed if members else {"Accuracy": tm}
    keyed_j = jm._keyed if members else {"Accuracy": jm}
    for owner, km in keyed_t.items():
        for name, value in km._get_states().items():
            np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(keyed_j[owner], name)))


@pytest.mark.parametrize("members", [False, True])
def test_snapshots_taken_while_updates_run_copy_no_batched_tensor(members):
    """A clone (the serving scheduler's refresh snapshot), a deepcopy and a
    pickle taken while another thread updates: an update binds the child's
    states to the vmap's batched tensors, so the child is copied under the
    serial lock. Every snapshot computes, and counts a whole number of the
    writer's batches (an update is never torn)."""
    import sys

    def build():
        if members:
            return T.MultiTenantCollection([T.Accuracy(**CPU)], N_TENANTS, validate_ids=False, **CPU)
        return T.KeyedMetric(T.Accuracy(**CPU), N_TENANTS, validate_ids=False, **CPU)

    tm = build()
    ids, preds, target = _writer_batches(0)[0]
    batch = (torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
    tm.update(*batch)  # built before the threads start
    errors, stop = [], threading.Event()

    def writer():
        try:
            while not stop.is_set():
                tm.update(*batch)
        except Exception as err:  # noqa: BLE001 - asserted below
            errors.append(err)

    def rows(obj):
        keyed = next(iter(obj._keyed.values())) if members else obj
        return int((keyed.tp + keyed.fp + keyed.tn + keyed.fn).sum())

    takers = [copy.deepcopy, lambda m: pickle.loads(pickle.dumps(m))] + ([] if members else [lambda m: m.clone()])
    snapshots = []
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # interleave the threads as often as the interpreter can
    thread = threading.Thread(target=writer)
    thread.start()
    try:
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and not errors:
            for take in takers:
                snapshots.append(take(tm))
    except Exception as err:  # noqa: BLE001 - asserted below
        errors.append(err)
    finally:
        sys.setswitchinterval(saved)
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors
    assert len(snapshots) > 10
    for snap in snapshots[::7]:
        assert rows(snap) % ROWS == 0 and rows(snap) >= ROWS
        snap.compute()
