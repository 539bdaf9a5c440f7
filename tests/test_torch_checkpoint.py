"""Checkpoints against the JAX package: the on-disk format, restores across
the two packages, crash consistency and the auto-save policy.

Counterparts of ``tests/durability/test_checkpoint.py``,
``test_crash_consistency.py`` and ``test_auto_save.py``. The same seeded
numpy batches go through a JAX keyed object and the port's; their snapshots
are compared manifest row by manifest row, and where the two packages keep a
leaf in one dtype (the keyed counts are int32 in both) the payload bytes
are equal (one sha256). A snapshot written by either package restores into
the other: integer and extremal leaves exactly, float leaves (float64 in the
JAX package under x64, float32 here) within float32 rounding.
"""
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as T
from metrics_tpu.durability import CheckpointManager as JManager
from metrics_tpu_torch.durability import (
    CheckpointCrash,
    CheckpointError,
    CheckpointManager,
    inject_crash,
    restore_checkpoint,
    save_checkpoint,
)
from metrics_tpu_torch.durability.checkpoint import CRASH_POINTS, list_snapshots, resolve_chain

N = 16
C = 4
CPU = {"device": "cpu"}


def _probs(rng, rows, c=C):
    x = rng.rand(rows, c).astype(np.float32)
    return x / x.sum(-1, keepdims=True)


#: (JAX object, port object, seeded batch) of each keyed kind compared
def _keyed_cm():
    return (J.KeyedMetric(J.ConfusionMatrix(num_classes=C), N, validate_ids=False),
            T.KeyedMetric(T.ConfusionMatrix(num_classes=C, **CPU), N, validate_ids=False, **CPU),
            lambda rng, ids: (ids, _probs(rng, len(ids)), rng.randint(0, C, len(ids))))


def _keyed_acc():
    return (J.KeyedMetric(J.Accuracy(), N, validate_ids=False),
            T.KeyedMetric(T.Accuracy(**CPU), N, validate_ids=False, **CPU),
            lambda rng, ids: (ids, rng.rand(len(ids)).astype(np.float32), rng.randint(0, 2, len(ids))))


def _collection():
    kw = dict(average="macro", num_classes=C)
    return (J.MultiTenantCollection({"Accuracy": J.Accuracy(), "Precision": J.Precision(**kw),
                                     "Recall": J.Recall(**kw)}, N, validate_ids=False),
            T.MultiTenantCollection({"Accuracy": T.Accuracy(**CPU), "Precision": T.Precision(**kw, **CPU),
                                     "Recall": T.Recall(**kw, **CPU)}, N, validate_ids=False, **CPU),
            lambda rng, ids: (ids, _probs(rng, len(ids)), rng.randint(0, C, len(ids))))


def _keyed_mse():
    return (J.KeyedMetric(J.MeanSquaredError(), N, validate_ids=False),
            T.KeyedMetric(T.MeanSquaredError(**CPU), N, validate_ids=False, **CPU),
            lambda rng, ids: (ids, rng.randn(len(ids)).astype(np.float32), rng.randn(len(ids)).astype(np.float32)))


KINDS = {"keyed_confmat": _keyed_cm, "keyed_accuracy": _keyed_acc, "collection": _collection, "keyed_mse": _keyed_mse}
#: kinds whose leaves have one dtype in both packages: byte-identical payloads
EXACT = ("keyed_confmat", "keyed_accuracy", "collection")


def _update(jm, tm, batch):
    jm.update(*[jnp.asarray(a) for a in batch])
    tm.update(*[torch.as_tensor(a) for a in batch])


def _leaves(obj):
    bundles = obj._keyed if getattr(obj, "_keyed", None) is not None else {"": obj}
    return {(o, n): np.asarray(v) for o, km in bundles.items() for n, v in km._get_states().items()}


def _assert_states(got, want, exact):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for key in g:
        if exact or g[key].dtype.kind != "f":
            np.testing.assert_array_equal(g[key], w[key].astype(g[key].dtype), err_msg=str(key))
        else:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, atol=1e-6, err_msg=str(key))


def _compare_rows(jrows, trows, exact):
    assert len(jrows) == len(trows)
    for j, t in zip(jrows, trows):
        for field in ("bundle", "name", "shape", "reduction"):
            assert j[field] == t[field], (field, j, t)
        if exact:
            assert j == t
        else:
            assert np.dtype(j["dtype"]).kind == np.dtype(t["dtype"]).kind


def _trail(kind, tmp_path, touched=3):
    """A full snapshot and a delta after ``touched`` tenants, on both packages."""
    jm, tm, batch = KINDS[kind]()
    rng = np.random.RandomState(7)
    _update(jm, tm, batch(rng, rng.randint(0, N, 64)))
    jmgr, tmgr = JManager(str(tmp_path / "jax"), jm), CheckpointManager(str(tmp_path / "torch"), tm)
    full = (jmgr.save(), tmgr.save())
    _update(jm, tm, batch(rng, rng.choice(N, touched, replace=False)))
    delta = (jmgr.save(), tmgr.save())
    return jm, tm, full, delta


@pytest.mark.parametrize("kind", list(KINDS))
def test_full_and_delta_manifests_equal_the_jax_package(kind, tmp_path):
    jm, tm, full, delta = _trail(kind, tmp_path)
    exact = kind in EXACT
    for j, t in (full, delta):
        _compare_rows(j["layout"], t["layout"], exact)
        for field in ("schema", "kind", "tenants", "metric", "keyed", "num_tenants", "capacity", "complete"):
            assert j[field] == t[field], field
        if exact:
            assert j["payload_bytes"] == t["payload_bytes"]
            assert [s["sha256"] for s in j["shards"]] == [s["sha256"] for s in t["shards"]]
    assert delta[1]["kind"] == "delta" and len(delta[1]["tenants"]) == 3
    assert delta[1]["parent"] == full[1]["name"]


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_a_snapshot_restores_into_the_other_package(kind, direction, tmp_path):
    jm, tm, _, _ = _trail(kind, tmp_path)
    fresh_j, fresh_t, _ = KINDS[kind]()
    if direction == "jax_to_torch":
        if hasattr(fresh_t, "build"):
            fresh_t.build()
        CheckpointManager(str(tmp_path / "jax"), fresh_t).restore()
        _assert_states(fresh_t, jm, kind in EXACT)
        want = jm.compute()
        got = fresh_t.compute()
    else:
        if hasattr(fresh_j, "build"):
            fresh_j.build(jnp.zeros((1, C)), jnp.zeros(1, jnp.int32))
        JManager(str(tmp_path / "torch"), fresh_j).restore()
        _assert_states(fresh_j, tm, kind in EXACT)
        want = tm.compute()
        got = fresh_j.compute()
    if isinstance(want, dict):
        for name in want:
            np.testing.assert_allclose(np.asarray(got[name], np.float64), np.asarray(want[name], np.float64),
                                       rtol=1e-6, equal_nan=True)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=1e-5,
                                   equal_nan=True)


def test_restore_is_topology_flexible(tmp_path):
    jm, tm, _, _ = _trail("keyed_accuracy", tmp_path)
    grown = T.KeyedMetric(T.Accuracy(**CPU), N, validate_ids=False, **CPU)
    grown.grow(3 * N)
    CheckpointManager(str(tmp_path / "torch"), grown).restore(grown)
    assert grown.capacity == 64 and grown.num_tenants == 3 * N
    np.testing.assert_array_equal(grown.tp[:N].numpy(), tm.tp.numpy())
    assert not grown.tp[N:].any()

    class Placed:
        calls = 0

        def place_state(self, state):
            Placed.calls += 1
            return {k: v.clone() for k, v in state.items()}

    target = T.KeyedMetric(T.Accuracy(**CPU), N, validate_ids=False, **CPU)
    CheckpointManager(str(tmp_path / "torch"), target).restore(target, transport=Placed())
    assert Placed.calls == 1
    _assert_states(target, tm, True)
    small = T.KeyedMetric(T.Accuracy(**CPU), N // 2, validate_ids=False, **CPU)
    with pytest.raises(CheckpointError, match="grow"):
        CheckpointManager(str(tmp_path / "torch"), small).restore(small)


def test_restore_errors_equal_the_jax_package(tmp_path):
    with pytest.raises(CheckpointError, match="no restorable snapshot"):
        CheckpointManager(str(tmp_path / "empty"), T.KeyedMetric(T.Accuracy(**CPU), N, **CPU)).restore()
    _trail("collection", tmp_path)
    with pytest.raises(CheckpointError, match="single metric"):
        CheckpointManager(str(tmp_path / "torch"), T.KeyedMetric(T.Accuracy(**CPU), N, **CPU)).restore()
    with pytest.raises(CheckpointError, match="do not match"):
        target = T.KeyedMetric(T.Accuracy(**CPU), N, **CPU)
        save_checkpoint(str(tmp_path / "cm"), T.KeyedMetric(T.ConfusionMatrix(num_classes=C, **CPU), N, **CPU))
        restore_checkpoint(str(tmp_path / "cm"), target)
    with pytest.raises(CheckpointError, match="list state"):
        CheckpointManager(str(tmp_path / "auroc"), T.AUROC(**CPU)).save()


def test_a_plain_metric_round_trips_and_matches_the_jax_manifest(tmp_path):
    rng = np.random.RandomState(3)
    preds, target = _probs(rng, 32), rng.randint(0, C, 32)
    jm, tm = J.ConfusionMatrix(num_classes=C), T.ConfusionMatrix(num_classes=C, **CPU)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.as_tensor(preds), torch.as_tensor(target))
    j = JManager(str(tmp_path / "j"), jm).save()
    t = CheckpointManager(str(tmp_path / "t"), tm).save()
    _compare_rows(j["layout"], t["layout"], True)
    assert t["keyed"] is False and [s["sha256"] for s in j["shards"]] == [s["sha256"] for s in t["shards"]]
    fresh = T.ConfusionMatrix(num_classes=C, **CPU)
    CheckpointManager(str(tmp_path / "j"), fresh).restore()
    assert torch.equal(fresh.confmat, tm.confmat)


def test_delta_saves_stamp_only_touched_tenants_and_chain(tmp_path):
    tm = T.KeyedMetric(T.ConfusionMatrix(num_classes=C, **CPU), 64, validate_ids=False, **CPU)
    rng = np.random.RandomState(0)
    tm.update(*map(torch.as_tensor, (rng.randint(0, 64, 256), _probs(rng, 256), rng.randint(0, C, 256))))
    mgr = CheckpointManager(str(tmp_path), tm)
    full = mgr.save()
    for k in (1, 5, 9):
        ids = rng.choice(64, k, replace=False)
        tm.update(*map(torch.as_tensor, (ids, _probs(rng, k), rng.randint(0, C, k))))
        delta = mgr.save()
        assert delta["kind"] == "delta" and sorted(delta["tenants"]) == sorted(ids.tolist())
        assert delta["payload_bytes"] <= full["payload_bytes"] * k / 64 + 256
    assert [m["kind"] for m in resolve_chain(str(tmp_path))] == ["full", "delta", "delta", "delta"]
    fresh = T.KeyedMetric(T.ConfusionMatrix(num_classes=C, **CPU), 64, validate_ids=False, **CPU)
    mgr.restore(fresh)
    assert torch.equal(fresh.confmat, tm.confmat)
    with pytest.raises(CheckpointError, match="delta save impossible"):
        CheckpointManager(str(tmp_path / "other"), tm).save(delta=True)
    assert mgr.save(delta=False)["kind"] == "full"
    assert mgr.report()["latest_kind"] == "full"


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_a_crashed_save_leaves_a_complete_restorable_snapshot(point, tmp_path):
    rng = np.random.RandomState(CRASH_POINTS.index(point))

    def update(m):
        m.update(torch.as_tensor(rng.randint(0, 8, 64)), torch.as_tensor(rng.rand(64).astype(np.float32)),
                 torch.as_tensor((rng.rand(64) < 0.5).astype(np.int32)))

    m = T.KeyedMetric(T.Accuracy(**CPU), 8, **CPU)
    update(m)
    mgr = CheckpointManager(str(tmp_path), m)
    base = mgr.save()
    at_base = m.tp.clone()
    update(m)
    at_crash = m.tp.clone()
    with pytest.raises(CheckpointCrash):
        with inject_crash(point):
            mgr.save()
    chain = resolve_chain(str(tmp_path))
    fresh = T.KeyedMetric(T.Accuracy(**CPU), 8, **CPU)
    mgr.restore(fresh)
    if point in ("after_rename", "before_latest"):
        assert len(chain) == 2 and torch.equal(fresh.tp, at_crash)
    else:
        assert [c["name"] for c in chain] == [base["name"]] and torch.equal(fresh.tp, at_base)


def test_a_fault_plan_crashes_the_save_and_the_retry_covers_the_dirty_set(tmp_path):
    import metrics_tpu_torch.resilience as res

    m = T.KeyedMetric(T.Accuracy(**CPU), 8, **CPU)
    m.update(torch.tensor([0, 1]), torch.tensor([0.9, 0.1]), torch.tensor([1, 0]))
    mgr = CheckpointManager(str(tmp_path), m)
    mgr.save()
    m.update(torch.tensor([2, 3]), torch.tensor([0.9, 0.1]), torch.tensor([1, 0]))
    plan = res.FaultPlan(0, [res.FaultSpec("checkpoint.before_manifest", "error", at=[0])])
    with res.fault_plan(plan):
        with pytest.raises(CheckpointCrash):
            mgr.save()
    m.update(torch.tensor([5]), torch.tensor([0.9]), torch.tensor([1]))
    retry = mgr.save()
    assert retry["kind"] == "delta" and retry["tenants"] == [2, 3, 5]
    assert plan.fired() == [("checkpoint.before_manifest", "error", 0)]
    with pytest.raises(ValueError, match="unknown crash point"):
        with inject_crash("nonsense"):
            pass


def test_save_async_overlaps_updates_and_resolves_to_the_cut(tmp_path):
    m = T.KeyedMetric(T.ConfusionMatrix(num_classes=C, **CPU), 64, validate_ids=False, **CPU)
    rng = np.random.RandomState(1)
    batch = lambda k: tuple(map(torch.as_tensor, (rng.randint(0, 64, k), _probs(rng, k), rng.randint(0, C, k))))  # noqa: E731
    m.update(*batch(128))
    mgr = CheckpointManager(str(tmp_path), m)
    mgr.save()
    m.update(*batch(16))
    cut = m.confmat.clone()
    future = mgr.save_async()
    while not future.done():
        m.update(*batch(16))
    manifest = future.result(timeout=30)
    fresh = T.KeyedMetric(T.ConfusionMatrix(num_classes=C, **CPU), 64, validate_ids=False, **CPU)
    mgr.restore(fresh)
    assert manifest["kind"] == "delta" and torch.equal(fresh.confmat, cut)


def test_history_prunes_only_behind_a_full_save(tmp_path):
    m = T.KeyedMetric(T.Accuracy(**CPU), 4, **CPU)
    mgr = CheckpointManager(str(tmp_path), m, history=2)
    for i in range(4):
        m.update(torch.tensor([i % 4]), torch.tensor([0.9]), torch.tensor([1]))
        mgr.save(delta=False if i % 2 == 0 else None)
    names = list_snapshots(str(tmp_path))
    assert len(names) <= 3 and resolve_chain(str(tmp_path))[0]["kind"] == "full"


def test_the_auto_save_policy_triggers_on_interval_and_dirty_threshold(tmp_path):
    m = T.KeyedMetric(T.Accuracy(**CPU), 32, **CPU)
    m.update(torch.tensor([0]), torch.tensor([0.9]), torch.tensor([1]))
    mgr = CheckpointManager(str(tmp_path), m)
    with pytest.raises(ValueError):
        mgr.enable_auto_save()
    with pytest.raises(ValueError):
        mgr.enable_auto_save(interval_s=0)
    mgr.save()
    assert mgr.dirty_count() == 0
    mgr.enable_auto_save(dirty_threshold=4, tick_s=0.01)
    m.update(torch.arange(5), torch.full((5,), 0.9), torch.ones(5, dtype=torch.int64))
    deadline = time.monotonic() + 10
    while mgr.auto_save_report()["auto_saves"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    mgr.disable_auto_save()
    from metrics_tpu_torch.utilities.async_sync import get_engine

    get_engine("durability").drain(timeout=10)
    report = mgr.auto_save_report()
    assert report["auto_saves"] >= 1 and not report["enabled"] and report["dirty_count"] == 0
    mgr.enable_auto_save(interval_s=0.05, tick_s=0.01)
    time.sleep(0.3)
    mgr.disable_auto_save()
    get_engine("durability").drain(timeout=10)
    assert mgr.auto_save_report()["auto_saves"] >= 2 and len(list_snapshots(str(tmp_path))) >= 3


def test_a_scheduler_supplies_the_marks_and_its_padding_id_is_not_stamped(tmp_path):
    m = T.KeyedMetric(T.Accuracy(**CPU), 8, validate_ids=False, **CPU)
    svc = T.SLOScheduler(m, start=False, pad_to_bucket=True, max_batch=8, **CPU)
    svc.submit_many(np.arange(3), np.ones(3, np.float32), np.ones(3, np.int32))
    svc.queue.flush()
    mgr = CheckpointManager(str(tmp_path), svc)
    mgr.save()
    svc.submit_many(np.array([4, 6, 6]), np.ones(3, np.float32), np.ones(3, np.int32))
    svc.queue.flush()  # padded to 4 rows with id -1, which the scheduler stamps
    assert -1 in svc.tenant_generations()
    delta = mgr.save()
    assert delta["kind"] == "delta" and delta["tenants"] == [4, 6]
    svc.close()


def test_durability_telemetry_equals_the_jax_package(tmp_path):
    from metrics_tpu import observability as jobs
    from metrics_tpu_torch import observability as tobs

    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
    jm, tm, _, _ = _trail("keyed_confmat", tmp_path)
    JManager(str(tmp_path / "jax"), J.KeyedMetric(J.ConfusionMatrix(num_classes=C), N)).restore()
    CheckpointManager(str(tmp_path / "torch"), T.KeyedMetric(T.ConfusionMatrix(num_classes=C, **CPU), N, **CPU)).restore()
    j, t = jobs.snapshot()["durability"], tobs.snapshot()["durability"]
    assert j == t and j["saves"] == 2 and j["delta_saves"] == 1 and j["tenants_stamped"] == 3
    jtext = {line for line in jobs.render_prometheus().splitlines() if line.startswith("metrics_tpu_durability_")
             and "seconds" not in line}
    ttext = {line for line in tobs.render_prometheus().splitlines() if line.startswith("metrics_tpu_durability_")
             and "seconds" not in line}
    assert jtext == ttext and jtext
    assert "durability_save_seconds{kind=delta}" in tobs.snapshot()["histograms"]


def test_concurrent_ingest_during_saves_keeps_every_row(tmp_path):
    m = T.KeyedMetric(T.Accuracy(**CPU), 16, validate_ids=False, **CPU)
    mgr = CheckpointManager(str(tmp_path), m)
    stop = threading.Event()
    sent = [0]

    def ingest():
        rng = np.random.RandomState(5)
        while not stop.is_set():
            m.update(torch.as_tensor(rng.randint(0, 16, 8)), torch.full((8,), 0.9), torch.ones(8, dtype=torch.int64))
            sent[0] += 8

    t = threading.Thread(target=ingest)
    t.start()
    for _ in range(5):
        mgr.save()
    stop.set()
    t.join()
    final = mgr.save()
    fresh = T.KeyedMetric(T.Accuracy(**CPU), 16, validate_ids=False, **CPU)
    mgr.restore(fresh)
    assert int(fresh.tp.sum()) == sent[0] == int(m.tp.sum()) and final["complete"]
