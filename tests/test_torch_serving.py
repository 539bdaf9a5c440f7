"""The port's serving plane against the JAX package's.

Every parity case feeds the same seeded numpy rows through the JAX
``metrics_tpu.serving`` object and the port's (``device="cpu"``), each queue
built with ``start=False`` and flushed by hand in the same order, and
compares:

* ``stats()`` exactly (submitted, admitted, shed by reason, dispatched,
  flushes, dead letters, resident), the staging block's clock-valued fields
  masked;
* what the target received (ids and columns, pad rows included);
* with a keyed target, the stacked states exactly and the values within
  1e-6, and ``tenant_report()`` with its clock-valued fields masked;
* the ``serving.*`` counters and the ``serving`` events' paths in order.

Both conservation laws are asserted after every case, the threaded ones
included. The staging ring and slot pool are held against the JAX
package's (wrap-around, slot reuse, the pad folded in place, pickling); the
scheduler's cache hits, stale serves, refreshes and their coalescing, the
per-tenant generations and the serving spans likewise.

Elsewhere: the cases that arm ``quarantine="auto"`` through
``observability.set_health_policy`` are in ``tests/test_torch_health.py``,
the serving timeline in ``tests/test_torch_slo_timeline.py`` and the fleet
snapshots in ``tests/test_torch_aggregate_fleet.py``, and the scheduler's
generation ledger after the keyed state is compacted in
``tests/test_torch_spill_elastic.py``. Left out, with the reason: the JAX
tests that count compiled executables per bucket (item 11).
"""
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
import metrics_tpu.serving as jserving
import metrics_tpu_torch as T
import metrics_tpu_torch.observability as tobs
import metrics_tpu_torch.serving as tserving
from metrics_tpu.serving import staging as jstaging
from metrics_tpu_torch.serving import staging as tstaging
from metrics_tpu_torch.serving.queue import DEAD_LETTER_CAP, SPAN_COHORT_CAP
from metrics_tpu_torch.utilities import async_sync as tas

CPU = {"device": "cpu"}
SIDES = {"jax": (jserving, jobs, {}), "torch": (tserving, tobs, CPU)}


@pytest.fixture(autouse=True)
def clean():
    for obs in (jobs, tobs):
        obs.enable()
        obs.reset()
    yield
    tas.get_engine().drain(timeout=10.0)
    for obs in (jobs, tobs):
        obs.enable()
        obs.reset()


class _Recorder:
    """Flush target recording every cohort it receives, as host arrays."""

    def __init__(self, fail_times: int = 0, delay_s: float = 0.0):
        self.calls = []
        self.fail_times = fail_times
        self.delay_s = delay_s
        self.lock = threading.Lock()

    def __call__(self, ids, *cols):
        if self.delay_s:
            time.sleep(self.delay_s)
        with self.lock:
            if self.fail_times > 0:
                self.fail_times -= 1
                raise RuntimeError("injected dispatch failure")
            self.calls.append((np.asarray(ids).copy(), [np.asarray(c).copy() for c in cols]))

    @property
    def rows(self):
        with self.lock:
            return sum(len(ids) for ids, _ in self.calls)


def _queue(side, target, **kw):
    serving, _, extra = SIDES[side]
    kw.setdefault("start", False)
    return serving.AdmissionQueue(target, **{**extra, **kw})


def _stats(q):
    s = q.stats()
    for k in ("stage_seconds", "overlap_seconds", "overlap_fraction"):
        s["staging"].pop(k, None)
    return s


def _assert_invariant(q):
    """Both conservation laws of the exact ledger."""
    s = q.stats()
    reasons = s["shed_by_reason"]
    post = sum(reasons.get(k, 0) for k in ("shed_oldest", "dispatch_error", "poisoned", "breaker_open"))
    assert s["admitted"] == s["dispatched"] + s["resident"] + post, s
    assert s["submitted"] - s["shed"] == s["dispatched"] + s["resident"], s


def _serving_counters(obs):
    s = dict(obs.snapshot()["serving"])
    s.pop("queues", None)
    return s


def _serving_events(obs):
    return [(e.payload.get("path"), e.payload.get("trigger"), e.payload.get("rows"))
            for e in obs.EVENTS.events() if e.kind == "serving"]


def _both(scenario, **kw):
    """Run ``scenario(side, **kw)`` on both packages; return both outputs and
    assert the ledgers, calls, serving counters and events are equal."""
    outs = {}
    for side in ("jax", "torch"):
        rec, q, extra = scenario(side, **kw)
        _assert_invariant(q)
        outs[side] = {"stats": _stats(q), "calls": rec.calls if rec is not None else None, "extra": extra,
                      "counters": _serving_counters(SIDES[side][1]), "events": _serving_events(SIDES[side][1])}
        q.close()
    j, t = outs["jax"], outs["torch"]
    assert t["stats"] == j["stats"]
    assert t["counters"] == j["counters"]
    assert t["events"] == j["events"]
    if j["calls"] is not None:
        assert len(t["calls"]) == len(j["calls"])
        for (tid, tcols), (jid, jcols) in zip(t["calls"], j["calls"]):
            np.testing.assert_array_equal(tid, jid)
            for a, b in zip(tcols, jcols):
                np.testing.assert_array_equal(a, b)
    assert t["extra"] == j["extra"]
    return j, t


# ---------------------------------------------------------------- policies


def test_policy_module_matches_the_jax_package():
    assert tserving.POLICIES == jserving.POLICIES
    from metrics_tpu.serving.policy import SHED_REASONS as JREASONS
    from metrics_tpu_torch.serving.policy import SHED_REASONS

    assert SHED_REASONS == JREASONS
    with pytest.raises(ValueError, match="one of"):
        tserving.resolve_policy("drop_everything")
    with pytest.raises(ValueError, match="block_timeout_s"):
        tserving.AdmissionPolicy("block", block_timeout_s=-1)
    with pytest.raises(ValueError, match="tenant_quota_rows"):
        tserving.AdmissionPolicy("shed_tenant_over_quota", tenant_quota_rows=0)
    with pytest.raises(ValueError, match="inside the AdmissionPolicy"):
        tserving.resolve_policy(tserving.AdmissionPolicy("block"), block_timeout_s=1.0)
    for args in (("shed_oldest",), ("block",), ("shed_tenant_over_quota",)):
        kw = {"tenant_quota_rows": 3} if args[0] == "shed_tenant_over_quota" else {"block_timeout_s": 0.5}
        assert repr(tserving.AdmissionPolicy(*args, **kw)) == repr(jserving.AdmissionPolicy(*args, **kw))


@pytest.mark.parametrize(
    "kw, error, match",
    [
        (dict(max_batch=0), ValueError, "max_batch"),
        (dict(max_delay_ms=0), ValueError, "max_delay_ms"),
        (dict(max_batch=8, capacity_rows=4), ValueError, "capacity_rows"),
        (dict(quarantine="sometimes"), ValueError, "quarantine"),
        (dict(staging=True, staging_slots=1), ValueError, "2 slots"),
    ],
)
def test_queue_constructor_validates(kw, error, match):
    with pytest.raises(error, match=match):
        _queue("torch", lambda *a: None, **kw)
    with pytest.raises(TypeError, match="callable"):
        tserving.AdmissionQueue(None, **CPU)


def test_the_default_device_is_the_card_or_the_targets_owner():
    km = T.KeyedMetric(T.Accuracy(**CPU), 4, **CPU)
    q = tserving.AdmissionQueue(km.update, start=False)
    assert q.device == torch.device("cpu")
    coll = T.MultiTenantCollection([T.Accuracy(**CPU)], 4, **CPU)
    assert tserving.AdmissionQueue(coll.update, start=False).device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserving.AdmissionQueue(lambda *a: None, start=False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserving.SLOScheduler(_FakeMetric(), start=False)
    svc = tserving.SLOScheduler(km, start=False)
    assert svc.queue.device == torch.device("cpu") and svc.device == torch.device("cpu")
    for queue in (q, svc.queue):
        queue.close()


# ---------------------------------------------------------------- triggers


@pytest.mark.parametrize("staging", [False, True])
def test_size_triggered_flush_coalesces_exactly_max_batch(staging):
    def scenario(side):
        rec = _Recorder()
        q = _queue(side, rec, max_batch=8, max_delay_ms=10_000.0, staging=staging)
        admitted = q.submit_many(np.arange(8), np.arange(8, dtype=np.float32))
        popped = q._flush_once("size")
        return rec, q, (admitted, popped)

    _, t = _both(scenario)
    assert t["extra"] == (8, 8) and t["stats"]["flushes"] == 1


@pytest.mark.parametrize("staging", [False, True])
def test_deadline_triggered_flush_dispatches_a_partial_batch(staging):
    rec = _Recorder()
    q = _queue("torch", rec, max_batch=1024, max_delay_ms=5.0, start=True, staging=staging)
    try:
        q.submit(3, np.float32(0.5))
        deadline = time.monotonic() + 1.0
        while rec.rows < 1 and time.monotonic() < deadline:
            time.sleep(0.002)
        assert rec.rows == 1
        assert q.drain(1.0)
        s = q.stats()
        assert s["flushes"] == 1 and s["resident"] == 0
        assert tobs.snapshot()["serving"]["flushes_by_trigger"] == {"deadline": 1}
        _assert_invariant(q)
    finally:
        q.close(timeout=1.0)


def test_size_trigger_fires_before_the_deadline():
    rec = _Recorder()
    q = _queue("torch", rec, max_batch=4, max_delay_ms=60_000.0, start=True)
    try:
        q.submit_many(np.arange(4), np.zeros(4, np.float32))
        deadline = time.monotonic() + 1.0
        while rec.rows < 4 and time.monotonic() < deadline:
            time.sleep(0.002)
        assert rec.rows == 4
        assert tobs.snapshot()["serving"]["flushes_by_trigger"] == {"size": 1}
    finally:
        q.close(timeout=1.0)


def test_submit_many_validates_column_shapes():
    q = _queue("torch", _Recorder())
    with pytest.raises(ValueError, match="one entry per row"):
        q.submit_many([1, 2], np.zeros(3))
    assert q.submit_many([], np.zeros(0)) == 0
    assert q.stats()["submitted"] == 0
    q.close()


# ---------------------------------------------------------------- policies at capacity


def _at_capacity(side, policy, staging):
    rec = _Recorder()
    if policy == "block":
        q = _queue(side, rec, max_batch=4, max_delay_ms=10_000.0, capacity_rows=4, policy="block",
                   block_timeout_s=0.02, staging=staging)
        out = [q.submit_many(np.arange(4), np.arange(4, dtype=np.float32)), q.submit(0, np.float32(9.0))]
    elif policy == "shed_oldest":
        q = _queue(side, rec, max_batch=4, max_delay_ms=10_000.0, capacity_rows=4, policy="shed_oldest",
                   staging=staging)
        out = [q.submit_many([0, 1, 2, 3], np.arange(4, dtype=np.float32)),
               q.submit_many([4, 5], np.asarray([4.0, 5.0], np.float32))]
    elif policy == "tenant_over_quota":
        q = _queue(side, rec, max_batch=64, max_delay_ms=10_000.0, capacity_rows=64,
                   policy="shed_tenant_over_quota", tenant_quota_rows=3, staging=staging)
        out = [q.submit_many(np.full(10, 7), np.zeros(10, np.float32)), q.submit_many([1, 2, 3], np.ones(3, np.float32))]
    else:  # queue_full
        q = _queue(side, rec, max_batch=4, max_delay_ms=10_000.0, capacity_rows=4,
                   policy="shed_tenant_over_quota", tenant_quota_rows=2, staging=staging)
        out = [q.submit_many([0, 1, 2, 3], np.zeros(4, np.float32)), q.submit(4, np.float32(0.0))]
    out.append(dict(q.stats()["shed_by_reason"]))
    q.flush()
    return rec, q, out


@pytest.mark.parametrize("staging", [False, True])
@pytest.mark.parametrize("policy", ["block", "shed_oldest", "tenant_over_quota", "queue_full"])
def test_every_policy_at_capacity_matches_the_jax_package(policy, staging):
    _, t = _both(_at_capacity, policy=policy, staging=staging)
    expected = {"block": {"block_timeout": 1}, "shed_oldest": {"shed_oldest": 2},
                "tenant_over_quota": {"tenant_over_quota": 7}, "queue_full": {"queue_full": 1}}[policy]
    assert t["extra"][-1] == expected
    if policy == "shed_oldest":
        np.testing.assert_array_equal(t["calls"][0][0], [2, 3, 4, 5])


def test_block_policy_waits_for_room():
    rec = _Recorder()
    q = _queue("torch", rec, max_batch=4, max_delay_ms=2.0, capacity_rows=4, policy="block", start=True)
    try:
        assert q.submit_many(np.arange(8) % 4, np.zeros(8, np.float32)) == 8
        assert q.drain(5.0)
        s = q.stats()
        assert s["shed"] == 0 and s["dispatched"] == 8
        _assert_invariant(q)
    finally:
        q.close(timeout=1.0)


def test_quota_default_derived_from_capacity():
    q = _queue("torch", _Recorder(), max_batch=4, capacity_rows=64, policy="shed_tenant_over_quota")
    assert q.policy.tenant_quota_rows == 8
    q.close()


# ---------------------------------------------------------------- errors / lifecycle


@pytest.mark.parametrize("staging", [False, True])
def test_dispatch_error_rows_are_accounted_shed(staging):
    def scenario(side):
        rec = _Recorder(fail_times=1)
        q = _queue(side, rec, max_batch=4, max_delay_ms=10_000.0, staging=staging)
        q.submit_many(np.arange(4), np.zeros(4, np.float32))
        with pytest.warns(UserWarning, match="dispatch failed"):
            q.flush()
        q.submit_many(np.arange(4), np.zeros(4, np.float32))
        q.flush()
        return rec, q, q.stats()["last_error"]

    _, t = _both(scenario)
    assert t["stats"]["shed_by_reason"] == {"dispatch_error": 4} and t["stats"]["dispatched"] == 4
    assert "injected dispatch failure" in t["extra"]


def test_closed_queue_rejects_submissions():
    q = _queue("torch", _Recorder(), max_batch=4, start=True)
    q.submit(0, np.float32(1.0))
    q.close(timeout=1.0)
    with pytest.raises(tserving.QueueClosedError):
        q.submit(0, np.float32(1.0))
    s = q.stats()
    assert s["closed"] is True and s["resident"] == 0 and s["dispatched"] == 1


def test_close_flushes_residue():
    rec = _Recorder()
    q = _queue("torch", rec, max_batch=1024, max_delay_ms=60_000.0, start=True)
    q.submit_many(np.arange(5), np.zeros(5, np.float32))
    q.close(timeout=1.0)
    assert rec.rows == 5
    assert not q._flusher.is_alive()


def test_drain_timeout_returns_false():
    rec = _Recorder(delay_s=0.2)
    q = _queue("torch", rec, max_batch=2, max_delay_ms=1.0, start=True)
    try:
        q.submit_many([0, 1], np.zeros(2, np.float32))
        time.sleep(0.02)
        assert q.drain(0.02) is False
        assert q.drain(2.0) is True
    finally:
        q.close(timeout=1.0)


@pytest.mark.parametrize("staging", [False, True])
def test_concurrent_producers_lose_nothing(staging):
    rec = _Recorder()
    q = _queue("torch", rec, max_batch=64, max_delay_ms=2.0, capacity_rows=512, policy="block", start=True,
               staging=staging)
    try:
        threads = [threading.Thread(target=lambda: [q.submit(i % 32, np.float32(i)) for i in range(200)])
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert q.drain(10.0)
        s = q.stats()
        assert s["admitted"] == 800 and s["shed"] == 0 and rec.rows == 800
        _assert_invariant(q)
    finally:
        q.close(timeout=2.0)


# ---------------------------------------------------------------- telemetry


def test_serving_snapshot_events_and_prometheus():
    def scenario(side):
        rec = _Recorder()
        q = _queue(side, rec, max_batch=4, max_delay_ms=10_000.0, capacity_rows=4, policy="shed_oldest")
        q.submit_many(np.arange(6), np.zeros(6, np.float32))
        q.flush()
        return rec, q, None

    _, t = _both(scenario)
    snap = tobs.snapshot()
    serving = snap["serving"]
    assert serving["admitted_rows"] == 6 and serving["shed_by_reason"] == {"shed_oldest": 2}
    assert serving["flushes_by_trigger"] == {"manual": 1}
    assert serving["shed_rows"] == sum(serving["shed_by_reason"].values())
    hists = snap["histograms"]
    for series in ("serving_flush_seconds", "serving_ingest_seconds", "serving_queue_depth",
                   "serving_queue_wait_seconds", "serving_dispatch_seconds"):
        assert any(k.startswith(series) for k in hists), series
    text = tobs.render_prometheus(snap)
    assert "metrics_tpu_serving_admitted_rows_total 6" in text
    assert 'metrics_tpu_serving_shed_by_reason_total{reason="shed_oldest"} 2' in text
    assert 'metrics_tpu_serving_flushes_by_trigger_total{trigger="manual"} 1' in text
    assert json.loads(json.dumps(snap))["serving"] == serving
    jtext = jobs.render_prometheus(jobs.snapshot())
    serving_lines = lambda text: sorted(l for l in text.splitlines()  # noqa: E731
                                        if l.startswith("metrics_tpu_serving_") and "seconds" not in l
                                        and "queue_depth" not in l and "queues" not in l)
    assert serving_lines(text) == serving_lines(jtext)


def test_telemetry_off_keeps_the_ledger_exact():
    tobs.disable()
    rec = _Recorder()
    q = _queue("torch", rec, max_batch=4, capacity_rows=4, policy="shed_oldest")
    q.submit_many(np.arange(6), np.zeros(6, np.float32))
    q.flush()
    s = q.stats()
    assert s["shed"] == 2 and s["dispatched"] == 4
    _assert_invariant(q)
    tobs.enable()
    assert tobs.snapshot()["serving"].get("admitted_rows", 0) == 0
    q.close()


@pytest.mark.parametrize("staging", [False, True])
def test_pad_to_bucket_dispatches_pow2_cohorts_with_discard_rows(staging):
    def scenario(side):
        rec = _Recorder()
        q = _queue(side, rec, max_batch=8, max_delay_ms=10_000.0, pad_to_bucket=True, staging=staging)
        q.submit_many([4, 2, 9], np.asarray([1.0, 2.0, 3.0], np.float32))
        q.flush()
        q.submit_many(np.arange(8), np.zeros(8, np.float32))
        q.flush()
        q.submit_many([1] * 5, np.ones(5, np.float32))
        q.flush()
        return rec, q, [len(ids) for ids, _ in rec.calls]

    _, t = _both(scenario)
    assert t["extra"] == [4, 8, 8]
    np.testing.assert_array_equal(t["calls"][0][0], [4, 2, 9, -1])
    np.testing.assert_array_equal(t["calls"][0][1][0], [1.0, 2.0, 3.0, 0.0])
    assert t["stats"]["dispatched"] == 16


# ---------------------------------------------------------------- keyed targets


def _keyed_pair(n, members=False, **kw):
    if members:
        jm = J.MultiTenantCollection([J.Accuracy(), J.Precision(num_classes=3, average="macro"),
                                      J.Recall(num_classes=3, average="macro"), J.F1(num_classes=3, average="macro")],
                                     n, **kw)
        tm = T.MultiTenantCollection([T.Accuracy(**CPU), T.Precision(num_classes=3, average="macro", **CPU),
                                      T.Recall(num_classes=3, average="macro", **CPU),
                                      T.F1(num_classes=3, average="macro", **CPU)], n, **kw, **CPU)
        return jm, tm
    return J.KeyedMetric(J.Accuracy(), n, **kw), T.KeyedMetric(T.Accuracy(**CPU), n, **kw, **CPU)


def _keyed_rows(seed, rows, n, multiclass=False):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, n, rows)
    if multiclass:
        logits = rng.randn(rows, 3).astype(np.float32)
        preds = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
        return ids, preds, rng.randint(0, 3, rows)
    preds = rng.rand(rows).astype(np.float32)
    return ids, preds, (rng.rand(rows) < preds).astype(np.int64)


def _states(m):
    bundles = m._keyed if hasattr(m, "_keyed") else {"": m}
    return {f"{o}.{k}": np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for o, km in bundles.items() for k, v in km._get_states().items()}


def _assert_keyed_equal(jm, tm):
    js, ts = _states(jm), _states(tm)
    assert js.keys() == ts.keys()
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    jv, tv = jm.compute(), tm.compute()
    if isinstance(jv, dict):
        for k in jv:
            np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), atol=1e-6, err_msg=k)
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def _masked_report(rep):
    rep = dict(rep)
    rep.pop("generated_unix_s")
    rep["staleness_s"] = {k: v is None for k, v in rep["staleness_s"].items()}
    rep["stalest"] = sorted(t["tenant"] for t in rep["stalest"])
    return rep


@pytest.mark.parametrize("staging", [False, True])
@pytest.mark.parametrize("members", [False, True])
def test_keyed_replay_through_the_queue_matches_the_jax_package_and_a_direct_update(members, staging):
    """Cohorts of a keyed replay (``validate_ids=False``, ``pad_to_bucket``,
    a ragged last cohort) through both packages' queues: the ledgers, the
    stacked states, the values, the tenant reports and the invalid-id count
    (the pad rows) agree, and the states equal a direct update of the same
    rows on the port."""
    n, cohorts = 12, [40, 64, 64, 37]
    jm, tm = _keyed_pair(n, members=members, validate_ids=False)
    _, direct = _keyed_pair(n, members=members, validate_ids=False)
    jq = jserving.AdmissionQueue(jm.update, max_batch=64, pad_to_bucket=True, start=False, staging=staging)
    tq = tserving.AdmissionQueue(tm.update, max_batch=64, pad_to_bucket=True, start=False, staging=staging)
    for step, rows in enumerate(cohorts):
        ids, preds, target = _keyed_rows(step, rows, n, multiclass=members)
        for q in (jq, tq):
            assert q.submit_many(ids, preds, target) == rows
            q.flush()
        direct.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
    assert _stats(tq) == _stats(jq)
    _assert_invariant(tq)
    _assert_keyed_equal(jm, tm)
    for k, v in _states(direct).items():
        np.testing.assert_array_equal(_states(tm)[k], v)
    rep, jrep = tm.tenant_report(), jm.tenant_report()
    assert rep["rows_routed"] == sum(cohorts) == tq.stats()["submitted"] - tq.stats()["shed"]
    assert rep["invalid_tenant_ids"] == (64 - 40) + (64 - 37)
    if jrep["invalid_tenant_ids"]:
        assert _masked_report(rep) == _masked_report(jrep)
    for q in (jq, tq):
        q.close()


def test_unstaged_and_staged_hand_the_target_host_views_with_their_twins():
    seen = []

    def target(ids, *cols):
        seen.append([(type(a).__name__, type(a.device_tensor).__name__, a.device_tensor.dtype) for a in (ids, *cols)])
        for a in (ids, *cols):
            np.testing.assert_array_equal(a.device_tensor.numpy(), np.asarray(a))

    for staging in (False, True):
        q = _queue("torch", target, max_batch=4, staging=staging)
        q.submit_many([0, 1], np.array([0.5, 0.25], np.float32), np.array([1, 0], np.int64))
        q.flush()
        q.close()
    assert seen[0] == seen[1] == [("StagedColumn", "Tensor", torch.int32), ("StagedColumn", "Tensor", torch.float32),
                                  ("StagedColumn", "Tensor", torch.int64)]


# ---------------------------------------------------------------- staging ring / slots


class TestStagingRing:
    def test_capacity_rounds_to_pow2(self):
        for n in (1, 5, 8, 9, 1000):
            assert tstaging.StagingRing(n).capacity == jstaging.StagingRing(n).capacity
        with pytest.raises(ValueError):
            tstaging.StagingRing(0)

    def test_lazy_bind_and_layout(self):
        cols = [np.zeros((3, 2), np.float32), np.zeros(3, np.int64)]
        assert tstaging.stage_layout(cols) == jstaging.stage_layout(cols) == (("float32", (2,)), ("int64", ()))
        ring = tstaging.StagingRing(8)
        assert not ring.bound
        ring.bind(tstaging.stage_layout(cols))
        assert ring.bound and ring.cols[0].shape == (8, 2) and ring.ids.dtype == np.int32

    @pytest.mark.parametrize("seq0", [0, 3, 6, 13])
    def test_write_read_roundtrip_with_wraparound(self, seq0):
        rings = []
        for mod in (jstaging, tstaging):
            ring = mod.StagingRing(8)
            vals = np.arange(5, dtype=np.float32) * 10
            ring.bind(mod.stage_layout([vals]))
            ring.head = seq0
            s0 = ring.alloc(5)
            ring.write_rows(s0, np.arange(5, dtype=np.int32) + 100, 1.5, "c", [vals])
            idx = [(s0 + k) & (ring.capacity - 1) for k in range(5)]
            rings.append((ring.read_ids(s0, 5), ring.ids[idx], ring.cols[0].copy(), ring.head))
        np.testing.assert_array_equal(rings[1][0], np.arange(5) + 100)
        for a, b in zip(rings[0], rings[1]):
            np.testing.assert_array_equal(a, b)

    def test_per_row_write_matches_bulk(self):
        vals = np.arange(6, dtype=np.float32)
        bulk, rows = tstaging.StagingRing(8), tstaging.StagingRing(8)
        for r in (bulk, rows):
            r.bind(tstaging.stage_layout([vals]))
            r.head = 5
        bulk.write_rows(bulk.alloc(6), np.arange(6, dtype=np.int32), 2.0, None, [vals])
        s = rows.alloc(6)
        for i in range(6):
            rows.write_row(s + i, i, 2.0, None, [vals[i]])
        np.testing.assert_array_equal(bulk.ids, rows.ids)
        np.testing.assert_array_equal(bulk.cols[0], rows.cols[0])

    def test_copy_out_wraps_into_a_slot(self):
        vals = np.arange(7, dtype=np.float32)
        ring = tstaging.StagingRing(8)
        ring.bind(tstaging.stage_layout([vals]))
        ring.head = 6
        s0 = ring.alloc(7)
        ring.write_rows(s0, np.arange(7, dtype=np.int32), 3.0, "k", [vals])
        slot = tstaging.StagingSlot(0, 1, 8, ring.layout)
        ring.copy_out(s0, 7, slot)
        np.testing.assert_array_equal(slot.ids[:7], np.arange(7))
        np.testing.assert_array_equal(slot.cols[0][:7], vals)
        assert list(slot.cohorts[:7]) == ["k"] * 7 and slot.tensors is None and slot.event is None

    def test_pickle_drops_buffers(self):
        ring = tstaging.StagingRing(8)
        ring.bind((("float32", ()),))
        ring.alloc(3)
        clone = pickle.loads(pickle.dumps(ring))
        assert clone.capacity == 8 and not clone.bound and clone.head == 0


class TestStagingSlotPool:
    def test_needs_two_slots(self):
        with pytest.raises(ValueError, match="2 slots"):
            tstaging.StagingSlotPool(1, 8)

    def test_acquire_release_cycle(self):
        pool = tstaging.StagingSlotPool(2, 8)
        pool.bind((("float32", ()),))
        a, b = pool.acquire(), pool.acquire()
        assert {a.index, b.index} == {0, 1} and pool.in_use() == 2
        assert pool.try_acquire() is None and pool.acquire(timeout=0.01) is None
        pool.release(a)
        again = pool.acquire()
        assert again is a and again.cols[0].shape == (8,)  # reused, not remade
        pool.release(again)
        pool.release(b)
        assert pool.in_use() == 0

    def test_rebind_bumps_generation(self):
        pool = tstaging.StagingSlotPool(2, 4)
        pool.bind((("float32", ()),))
        slot = pool.acquire()
        pool.bind((("float32", ()), ("int64", ())))
        fresh = pool.refresh(slot)
        assert fresh is not slot and len(fresh.cols) == 2 and fresh.generation == slot.generation + 1
        assert pool.refresh(fresh) is fresh

    def test_pickle_drops_slots(self):
        pool = tstaging.StagingSlotPool(3, 4)
        pool.bind((("float32", ()),))
        pool.acquire()
        clone = pickle.loads(pickle.dumps(pool))
        assert clone.num_slots == 3 and clone.rows == 4 and clone.in_use() == 0 and clone.pin is False


class TestStagedColumn:
    def test_as_staged_none_is_passthrough(self):
        a = np.arange(3)
        assert tstaging.as_staged(a, None) is a

    def test_twin_attached_and_dropped_on_derivation(self):
        host = np.arange(4, dtype=np.float32)
        twin = torch.from_numpy(host).clone()
        staged = tstaging.as_staged(host, twin)
        assert isinstance(staged, tstaging.StagedColumn) and staged.device_tensor is twin
        assert staged[1:].device_tensor is None and (staged + 1).device_tensor is None
        assert np.shares_memory(staged, host)

    def test_pickle_drops_twin(self):
        staged = tstaging.as_staged(np.arange(3), torch.arange(3))
        clone = pickle.loads(pickle.dumps(staged))
        assert clone.device_tensor is None
        np.testing.assert_array_equal(clone, [0, 1, 2])


# ---------------------------------------------------------------- staged flush


class TestStagedFlush:
    def test_rows_dispatch_with_device_twins(self):
        seen = {}
        rec = _Recorder()

        def target(ids, *cols):
            seen["ids"] = ids.device_tensor
            seen["cols"] = [c.device_tensor for c in cols]
            rec(ids, *cols)

        q = _queue("torch", target, max_batch=8, staging=True)
        for i in range(8):
            q.submit(i, np.float32(i * 2))
        assert q._flush_once("manual") == 8
        _assert_invariant(q)
        np.testing.assert_array_equal(rec.calls[0][0], np.arange(8))
        assert torch.equal(seen["ids"], torch.arange(8, dtype=torch.int32))
        assert torch.equal(seen["cols"][0], torch.arange(8, dtype=torch.float32) * 2)
        q.close()

    def test_transfer_off_hands_plain_owning_numpy(self):
        def scenario(side):
            calls = []
            q = _queue(side, lambda ids, *cols: calls.append((ids, cols)), max_batch=8, staging=True,
                       staging_transfer=False)
            for i in range(4):
                q.submit(i, np.float32(i))
            q._flush_once("manual")
            for _ in range(4):
                q.submit(9, np.float32(99.0))
            q._flush_once("manual")
            first_ids, first_cols = calls[0]
            assert type(first_ids) is np.ndarray and all(type(c) is np.ndarray for c in first_cols)
            return None, q, (first_ids.tolist(), first_cols[0].tolist())

        _, t = _both(scenario)
        assert t["extra"] == ([0, 1, 2, 3], [0.0, 1.0, 2.0, 3.0])

    def test_schema_change_with_resident_rows_raises(self):
        def scenario(side):
            rec = _Recorder()
            q = _queue(side, rec, max_batch=8, staging=True)
            q.submit(0, np.float32(1.0))
            with pytest.raises(ValueError, match="schema"):
                q.submit(1, np.float32(1.0), np.float32(2.0))
            before = (q.stats()["submitted"], q.stats()["admitted"])
            q._flush_once("manual")
            assert q.submit(1, np.float32(1.0), np.float32(2.0))
            q._flush_once("manual")
            return rec, q, before

        _, t = _both(scenario)
        assert t["extra"] == (1, 1) and t["stats"]["dispatched"] == 2

    def test_stats_staging_block(self):
        q = _queue("torch", _Recorder(), max_batch=8, staging=True, staging_slots=3)
        for i in range(8):
            q.submit(i, np.float32(i))
        q._flush_once("manual")
        st = q.stats()["staging"]
        assert st["enabled"] is True and st["slots"] == 3 and st["staged_cohorts"] == 1
        assert st["ring_capacity"] == 128 and st["transfer"] is True
        assert st["stage_seconds"] > 0 and 0.0 <= st["overlap_fraction"] <= 1.0
        q.close()
        off = _queue("torch", _Recorder(), max_batch=8)
        assert off.stats()["staging"] == {"enabled": False}
        off.close()

    def test_breaker_open_sheds_under_exact_reason(self):
        def scenario(side):
            serving = SIDES[side][0]
            from metrics_tpu.resilience import CircuitBreaker as JB
            from metrics_tpu_torch.resilience import CircuitBreaker as TB

            rec = _Recorder(fail_times=2)
            cb = (JB if side == "jax" else TB)(failure_threshold=2, reset_after_s=60.0)
            q = _queue(side, rec, max_batch=8, staging=True, breaker=cb)
            with pytest.warns(UserWarning):
                for _ in range(3):
                    for i in range(4):
                        q.submit(i, np.float32(i))
                    q._flush_once("manual")
            return rec, q, cb.state

        _, t = _both(scenario)
        assert t["stats"]["shed_by_reason"] == {"dispatch_error": 8, "breaker_open": 4}
        assert t["stats"]["dispatched"] == 0 and t["extra"] == "open"

    def test_quarantine_sheds_with_dead_letters(self):
        def scenario(side):
            rec = _Recorder()
            q = _queue(side, rec, max_batch=8, staging=True, quarantine="on")
            vals = np.arange(8, dtype=np.float32)
            vals[2], vals[5] = np.nan, np.inf
            for i, v in enumerate(vals):
                q.submit(i, np.float32(v))
            q._flush_once("manual")
            return rec, q, sorted(t for t, _ in q.dead_letters())

        _, t = _both(scenario)
        assert t["stats"]["shed_by_reason"] == {"poisoned": 2} and t["stats"]["dispatched"] == 6
        assert t["extra"] == [2, 5]

    def test_pickled_staged_scratch_rebuilds(self):
        q = _queue("torch", _Recorder(), max_batch=8, staging=True)
        for i in range(4):
            q.submit(i, np.float32(i))
        q._flush_once("manual")
        ring, slots = pickle.loads(pickle.dumps(q._ring)), pickle.loads(pickle.dumps(q._slots))
        assert not ring.bound and ring.head == 0 and slots.in_use() == 0
        q.submit(7, np.float32(7.0))
        q._flush_once("manual")
        _assert_invariant(q)
        q.close()

    @pytest.mark.parametrize("pad", [False, True])
    def test_ring_wraparound_and_slot_reuse_match_the_jax_package(self, pad):
        """A 16-row ring (capacity 8, two 4-row slots) filled and flushed
        over many cohorts of varying size: sequences wrap the ring several
        times and each slot is refilled again and again. A full queue sheds
        the incoming row (``queue_full``): ``shed_oldest`` at capacity races
        the JAX queue's late copy of a prefetched cohort (the next test)."""

        def scenario(side):
            rec = _Recorder()
            q = _queue(side, rec, max_batch=4, capacity_rows=8, staging=True, pad_to_bucket=pad,
                       policy="shed_tenant_over_quota", tenant_quota_rows=8)
            rng = np.random.RandomState(7)
            for step in range(25):
                n = int(rng.randint(1, 9))
                q.submit_many(rng.randint(0, 50, n), rng.rand(n).astype(np.float32),
                              rng.randint(0, 3, n).astype(np.int64))
                if step % 3 != 2:
                    q._flush_once("manual")
            q.flush()
            return rec, q, (q._ring.capacity, q._ring.head)

        _, t = _both(scenario)
        assert t["extra"][0] == 16 and t["extra"][1] > 3 * 16

    @pytest.mark.parametrize("seed", [7, 8, 9])
    def test_shed_oldest_at_capacity_never_dispatches_a_row_twice(self, seed):
        """Staged, ``shed_oldest``, at capacity, with prefetches: every
        dispatched row was submitted, none twice, and the dispatch is the
        same run after run. The port copies a popped cohort out of the ring
        under the admission lock; the JAX queue copies a prefetched cohort on
        the staging lane, after which evicting producers may already have
        wrapped the ring over it (it dispatches 4 of 76 rows twice in most
        runs of seed 7, ROADMAP queue C)."""

        def run():
            rec = _Recorder()
            q = _queue("torch", rec, max_batch=4, capacity_rows=8, staging=True, pad_to_bucket=True,
                       policy="shed_oldest")
            rng = np.random.RandomState(seed)
            submitted = set()
            for step in range(25):
                n = int(rng.randint(1, 9))
                ids, vals = rng.randint(0, 50, n), rng.rand(n).astype(np.float32)
                submitted.update(zip(ids.tolist(), vals.tolist()))
                q.submit_many(ids, vals, rng.randint(0, 3, n).astype(np.int64))
                if step % 3 != 2:
                    q._flush_once("manual")
            q.flush()
            _assert_invariant(q)
            q.close()
            pairs = [(int(i), float(v)) for ids, cols in rec.calls for i, v in zip(ids, cols[0]) if i >= 0]
            assert len(pairs) == len(set(pairs)) == q.stats()["dispatched"]
            assert set(pairs) <= submitted
            return pairs

        first = run()
        for _ in range(3):
            assert run() == first

    def test_prefetch_overlaps_the_next_cohort(self):
        def scenario(side):
            rec = _Recorder()
            q = _queue(side, rec, max_batch=4, capacity_rows=16, staging=True)
            q.submit_many(np.arange(12), np.arange(12, dtype=np.float32))
            q._flush_once("size")  # stages one, prefetches the next full cohort
            resident_with_prefetch = q.depth()
            q.flush()
            return rec, q, (resident_with_prefetch, q.stats()["staging"]["prefetched_cohorts"])

        _, t = _both(scenario)
        assert t["extra"] == (8, 2)


# ---------------------------------------------------------------- quarantine


def _recording_queue(side, **kwargs):
    rec = _Recorder()
    return rec, _queue(side, rec, max_batch=8, **kwargs)


@pytest.mark.parametrize("staging", [False, True])
def test_poisoned_rows_shed_exactly_and_clean_rows_dispatch(staging):
    def scenario(side):
        rec, q = _recording_queue(side, quarantine="on", staging=staging)
        preds = np.array([0.1, np.nan, 0.3, np.inf, -np.inf, 0.6], np.float32)
        target = np.array([1, 0, 1, 1, 0, 1], np.int32)
        q.submit_many(np.arange(6), preds, target)
        q.flush()
        return rec, q, [t for t, _ in q.dead_letters()]

    _, t = _both(scenario)
    assert t["stats"]["shed_by_reason"] == {"poisoned": 3} and t["stats"]["dead_letter_rows"] == 3
    np.testing.assert_array_equal(t["calls"][0][0], [0, 2, 5])
    assert t["extra"] == [1, 3, 4]


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_quarantine_auto_and_off_let_nan_rows_through(mode):
    """``"off"`` never scans; ``"auto"`` follows the health policy, whose
    default ``"off"`` leaves the scan off in both packages (the armed
    policies are in ``tests/test_torch_health.py``)."""

    def scenario(side):
        rec, q = _recording_queue(side, quarantine=mode)
        q.submit_many([0, 1], np.array([0.1, np.nan], np.float32))
        q.flush()
        return rec, q, None

    _, t = _both(scenario)
    assert t["stats"]["shed"] == 0 and len(t["calls"][0][0]) == 2


def test_all_poisoned_cohort_dispatches_nothing_but_drains():
    def scenario(side):
        rec, q = _recording_queue(side, quarantine="on")
        q.submit_many([0, 1, 2], np.full(3, np.nan, np.float32))
        q.flush()
        return rec, q, q.depth()

    _, t = _both(scenario)
    assert t["calls"] == [] and t["stats"]["shed_by_reason"] == {"poisoned": 3} and t["extra"] == 0


def test_integer_columns_are_never_scanned():
    def scenario(side):
        rec, q = _recording_queue(side, quarantine="on")
        q.submit_many([0, 1], np.array([1, 2], np.int32), np.array([3, 4], np.int64))
        q.flush()
        return rec, q, None

    _, t = _both(scenario)
    assert t["stats"]["dispatched"] == 2


def test_dead_letter_sample_is_bounded_while_count_stays_exact():
    rec, q = _recording_queue("torch", quarantine="on")
    n = DEAD_LETTER_CAP + 10
    q.max_batch = n
    q.submit_many(np.arange(n), np.full(n, np.nan, np.float32))
    q.flush()
    assert q.stats()["shed_by_reason"] == {"poisoned": n}
    dead = q.dead_letters()
    assert len(dead) == DEAD_LETTER_CAP and dead[-1][0] == n - 1
    q.close()


def test_poisoned_rows_never_corrupt_keyed_state():
    jm, tm = _keyed_pair(4, validate_ids=False)
    jq = jserving.AdmissionQueue(jm.update, max_batch=8, quarantine="on", start=False)
    tq = tserving.AdmissionQueue(tm.update, max_batch=8, quarantine="on", start=False)
    preds = np.array([0.9, np.nan, 0.2, 0.7], np.float32)
    for q in (jq, tq):
        q.submit_many([0, 1, 2, 3], preds, np.array([1, 1, 0, 1], np.int64))
        q.flush()
    _assert_keyed_equal(jm, tm)
    assert tm.tenant_report()["rows_routed"] == 3
    assert _stats(tq) == _stats(jq)


# ---------------------------------------------------------------- traces


def _serving_spans(obs, bucket=None):
    return [s for s in obs.TRACER.records() if s.kind == "serving" and (bucket is None or s.bucket == bucket)]


def _span_shape(obs):
    return [(s.bucket, s.seq, {k: v for k, v in s.payload.items() if k not in ("cohorts", "staleness_s")})
            for s in _serving_spans(obs)]


def test_submit_and_dispatch_spans_match_the_jax_package():
    for side in ("jax", "torch"):
        q = _queue(side, lambda *a: None, max_batch=8, capacity_rows=8, policy="shed_oldest")
        q.submit_many(np.arange(12), np.zeros(12, np.float32))
        q.submit_many(np.arange(4), np.ones(4, np.float32))
        while q._flush_once("manual"):
            pass
        q.close()
    assert _span_shape(tobs) == _span_shape(jobs)
    (first, second) = _serving_spans(tobs, "submit")
    assert first.payload == {"rows": 12, "admitted": 12, "shed": 0}
    (dispatch,) = _serving_spans(tobs, "dispatch")
    assert dispatch.payload["cohorts"] == [first.span_id, second.span_id]
    (wait,) = _serving_spans(tobs, "wait")
    assert wait.exit_s == pytest.approx(dispatch.enter_s, abs=5e-3)
    assert wait.enter_s <= wait.exit_s <= dispatch.exit_s


def test_cohort_list_is_capped_with_explicit_drop_count():
    q = _queue("torch", lambda *a: None, max_batch=1024, capacity_rows=4096)
    n = SPAN_COHORT_CAP + 3
    for i in range(n):
        q.submit_many([i], np.zeros(1, np.float32))
    assert q.flush() == n
    (dispatch,) = _serving_spans(tobs, "dispatch")
    assert len(dispatch.payload["cohorts"]) == SPAN_COHORT_CAP and dispatch.payload["dropped_cohorts"] == 3
    assert q.last_dispatch_span() == dispatch.span_id
    q.close()


def test_record_span_matches_the_jax_package():
    for tracer in (jobs.TRACER, tobs.TRACER):
        tracer.record_span("serving", group="g", bucket="wait", enter_ago_s=0.5, exit_ago_s=0.2, rows=3)
        tracer.record_span("serving", group="g", bucket="wait", enter_ago_s=0.1, exit_ago_s=0.4)  # clamped
    for jspan, tspan in zip(jobs.TRACER.records(), tobs.TRACER.records()):
        assert tspan.span_id == jspan.span_id and tspan.payload == jspan.payload
        assert tspan.exit_s - tspan.enter_s == pytest.approx(jspan.exit_s - jspan.enter_s, abs=5e-3)
    first, second = tobs.TRACER.records()
    assert first.exit_s - first.enter_s == pytest.approx(0.3, abs=5e-3) and second.exit_s == second.enter_s
    tobs.disable()
    assert tobs.TRACER.record_span("serving", enter_ago_s=1.0) is None
    tobs.enable()


def test_disabled_tracer_records_no_serving_spans():
    tobs.disable()
    try:
        q = _queue("torch", lambda *a: None, max_batch=8)
        q.submit_many(np.arange(4), np.zeros(4, np.float32))
        q.flush()
        assert _serving_spans(tobs) == [] and q.last_dispatch_span() is None
        q.close()
    finally:
        tobs.enable()


# ---------------------------------------------------------------- the scheduler


class _FakeMetric:
    """Metric-shaped double: per-tenant running sums; the compute counter is
    shared with clones (the scheduler computes on detached snapshots)."""

    def __init__(self, n=8, compute_delay_s=0.0, sums=None, counter=None):
        self.n = n
        self.compute_delay_s = compute_delay_s
        self.sums = np.zeros(n) if sums is None else sums.copy()
        self._computes = counter if counter is not None else [0]
        self.lock = threading.Lock()

    @property
    def computes(self):
        return self._computes[0]

    def update(self, tenant_ids, values):
        with self.lock:
            np.add.at(self.sums, np.asarray(tenant_ids), np.asarray(values))

    def compute(self):
        if self.compute_delay_s:
            time.sleep(self.compute_delay_s)
        with self.lock:
            self._computes[0] += 1
            return self.sums.copy()

    def clone(self):
        with self.lock:
            return _FakeMetric(self.n, self.compute_delay_s, self.sums, self._computes)


def _svc(side, metric, **kw):
    serving, _, extra = SIDES[side]
    kw.setdefault("start", False)
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_delay_ms", 10_000.0)
    return serving.SLOScheduler(metric, **{**extra, **kw})


def test_scheduler_validates_metric():
    with pytest.raises(TypeError, match="update"):
        tserving.SLOScheduler(object(), **CPU)
    with pytest.raises(ValueError, match="max_staleness_s"):
        tserving.SLOScheduler(_FakeMetric(), max_staleness_s=-1, **CPU)


def _read_outcomes(obs):
    return [s.payload["outcome"] for s in _serving_spans(obs, "read")]


def test_read_outcomes_match_the_jax_package():
    """Miss, fresh hit, stale serve, tenant-scoped hit and miss again, on
    both packages, in the same order: the outcomes, generations, values and
    the scheduler's counters agree."""
    outs = {}
    for side in ("jax", "torch"):
        m = _FakeMetric()
        svc = _svc(side, m)
        values = []
        svc.submit(3, 1.0)
        values.append(svc.read(max_staleness_s=0.0).tolist())       # miss
        values.append(svc.read([3]).tolist())                        # fresh hit
        svc.submit(3, 1.0)
        svc.queue.flush()
        values.append(svc.read(max_staleness_s=60.0).tolist())      # stale serve
        svc.refresh(wait=True)
        svc.submit(5, 2.0)
        svc.queue.flush()
        values.append(svc.read([3], max_staleness_s=0.0).tolist())  # tenant-scoped hit
        values.append(svc.read([5], max_staleness_s=0.0).tolist())  # miss
        svc.submit(5, 1.0)
        svc.queue.flush()
        values.append(svc.read([7], max_staleness_s=0.0).tolist())  # never written: hit
        assert tas.get_engine().drain(5.0)
        rep = svc.report()
        rep.pop("cache_age_s")
        rep["queue"] = _stats(svc.queue)
        outs[side] = (values, _read_outcomes(SIDES[side][1]), rep, _serving_counters(SIDES[side][1]),
                      svc.tenant_generations(), m.computes)
        svc.close()
    assert outs["torch"] == outs["jax"]
    values, outcomes = outs["torch"][:2]
    assert outcomes == ["cache_miss", "cache_hit", "stale_serve", "tenant_cache_hit", "cache_miss", "tenant_cache_hit"]
    assert values[:2] == [[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0], [1.0]]


def test_generation_bump_invalidates_the_cache():
    m = _FakeMetric()
    svc = _svc("torch", m)
    svc.submit(1, 2.0)
    assert svc.read(max_staleness_s=0.0)[1] == 2.0 and svc.generation == 1
    svc.submit(1, 3.0)
    svc.queue.flush()
    assert svc.generation == 2 and svc.report()["cache_fresh"] is False
    assert svc.read(max_staleness_s=0.0)[1] == 5.0
    svc.close()


def test_resident_rows_defeat_cache_freshness():
    m = _FakeMetric()
    svc = _svc("torch", m)
    svc.submit(0, 1.0)
    svc.read(max_staleness_s=0.0)
    svc.submit(0, 1.0)  # resident, not yet flushed
    assert svc.read(max_staleness_s=0.0)[0] == 2.0  # read-your-writes flushed it
    svc.close()


def test_stale_within_budget_serves_and_refreshes_in_background():
    m = _FakeMetric()
    svc = _svc("torch", m)
    svc.submit(3, 1.0)
    assert svc.read(max_staleness_s=0.0)[3] == 1.0
    svc.submit(3, 1.0)
    svc.queue.flush()
    before = tserving.SERVING_STATS.counter("stale_serves")
    assert svc.read(max_staleness_s=60.0)[3] == 1.0
    assert tserving.SERVING_STATS.counter("stale_serves") == before + 1
    svc.refresh().result(timeout=10.0)
    svc.refresh(wait=True)
    assert svc.read(max_staleness_s=60.0)[3] == 2.0
    svc.close()


def test_concurrent_stale_reads_coalesce_one_refresh():
    m = _FakeMetric(compute_delay_s=0.1)
    svc = _svc("torch", m)
    svc.submit(0, 1.0)
    results = []
    threads = [threading.Thread(target=lambda: results.append(svc.read(max_staleness_s=0.0))) for _ in range(4)]
    before = tserving.SERVING_STATS.counter("coalesced_refreshes")
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 4 and all(r[0] == 1.0 for r in results)
    assert m.computes <= 2
    assert tserving.SERVING_STATS.counter("coalesced_refreshes") >= before + 2
    svc.close()


def test_updates_keep_flowing_during_an_inflight_read():
    m = _FakeMetric(compute_delay_s=0.3)
    svc = _svc("torch", m, max_batch=4, max_delay_ms=2.0, start=True)
    try:
        svc.submit(0, 1.0)
        assert svc.drain(2.0)
        fut = svc.refresh()
        t0 = time.monotonic()
        svc.submit_many(np.arange(4), np.ones(4))
        assert svc.drain(2.0)
        assert time.monotonic() - t0 < 0.25
        fut.result(timeout=10.0)
    finally:
        svc.close(timeout=2.0)


@pytest.mark.parametrize("staging", [False, True])
def test_keyed_metric_end_to_end(staging):
    outs = {}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 16, 128)
    preds = rng.rand(128).astype(np.float32)
    target = (preds > 0.5).astype(np.int64)
    for side, pkg in (("jax", J), ("torch", T)):
        m = pkg.KeyedMetric(pkg.Accuracy(**SIDES[side][2]), num_tenants=16, **SIDES[side][2])
        svc = _svc(side, m, max_batch=32, max_delay_ms=2.0, max_staleness_s=0.0, start=True, staging=staging)
        try:
            assert svc.submit_many(ids, preds, target) == 128
            values = np.asarray(svc.read())
            sel = svc.read(np.unique(ids))
            s = svc.queue.stats()
            outs[side] = (values, np.asarray(sel), m.tenant_report()["rows_routed"], s["submitted"] - s["shed"])
        finally:
            svc.close(timeout=2.0)
    np.testing.assert_allclose(outs["torch"][0], outs["jax"][0], atol=1e-6)
    np.testing.assert_allclose(outs["torch"][1], 1.0)
    assert isinstance(outs["torch"][1], np.ndarray)
    assert outs["torch"][2] == outs["torch"][3] == 128 == outs["jax"][2]


def test_multitenant_collection_reads_select_per_member():
    outs = {}
    for side, pkg in (("jax", J), ("torch", T)):
        kw = SIDES[side][2]
        coll = pkg.MultiTenantCollection(
            [pkg.Accuracy(**kw), pkg.Precision(num_classes=2, average="macro", multiclass=True, **kw)], 8, **kw)
        svc = _svc(side, coll, max_batch=16, max_staleness_s=0.0)
        svc.submit_many([2, 2, 5], np.asarray([0.9, 0.8, 0.2], np.float32), np.asarray([1, 1, 0], np.int64))
        out = svc.read([2, 5])
        outs[side] = {k: np.asarray(v) for k, v in out.items()}
        svc.close()
    assert set(outs["torch"]) == {"Accuracy", "Precision"}
    for k in outs["jax"]:
        np.testing.assert_allclose(outs["torch"][k], outs["jax"][k], atol=1e-6)
    np.testing.assert_allclose(outs["torch"]["Accuracy"], [1.0, 1.0])


def test_refresh_rides_the_async_engine_generations():
    m = T.KeyedMetric(T.Accuracy(**CPU), num_tenants=4, **CPU)
    svc = _svc("torch", m)
    svc.submit(0, np.float32(0.9), np.int64(1))
    svc.read(max_staleness_s=0.0)
    assert tas.get_engine().last_generation(m.telemetry_key) >= 1
    assert tobs.snapshot()["async_sync"]["submitted"] >= 1
    refresh_events = [e for e in tobs.EVENTS.events() if e.kind == "serving" and e.payload.get("path") == "refresh"]
    assert refresh_events and refresh_events[0].payload["generation"] == 1
    svc.close()


def test_scheduler_report_shape():
    m = _FakeMetric()
    svc = _svc("torch", m)
    rep = svc.report()
    assert rep["cache_generation"] is None and rep["cache_fresh"] is False
    assert rep["tenant_generations_tracked"] == 0 and rep["membership_epoch"] == 0
    svc.submit(0, 1.0)
    svc.read(max_staleness_s=0.0)
    rep = svc.report()
    assert rep["generation"] == 1 and rep["cache_generation"] == 1 and rep["queue"]["admitted"] == 1
    assert rep["tenant_generations_tracked"] == 1 and "tenants" not in rep
    json.dumps(rep)
    assert "SLOScheduler(_FakeMetric" in repr(svc)
    svc.close()
    km = T.KeyedMetric(T.Accuracy(**CPU), 4, **CPU)
    svc = _svc("torch", km)
    svc.submit(1, np.float32(0.9), np.int64(1))
    svc.drain(1.0)
    assert svc.report()["tenants"]["rows_routed"] == 1
    svc.close()


def test_tenant_generations_accessor_is_a_consistent_copy():
    m = T.KeyedMetric(T.Accuracy(**CPU), 4, validate_ids=False, **CPU)
    svc = _svc("torch", m)
    svc.submit(2, np.float32(0.9), np.int64(1))
    svc.queue.flush()
    gens = svc.tenant_generations()
    assert gens == {2: 1}
    gens[3] = 99
    assert svc.tenant_generations() == {2: 1}
    svc.close()


def test_read_span_references_the_serving_flush():
    svc = _svc("torch", _FakeMetric())
    try:
        svc.submit(2, 5.0)
        svc.read(max_staleness_s=0.0)
        svc.read([2])
    finally:
        svc.close()
    reads = _serving_spans(tobs, "read")
    assert [r.payload["outcome"] for r in reads] == ["cache_miss", "cache_hit"]
    dispatch_ids = {s.span_id for s in _serving_spans(tobs, "dispatch")}
    assert reads[-1].payload["flush_span"] in dispatch_ids


# ---------------------------------------------------------------- threaded parity


@pytest.mark.parametrize("staging", [False, True])
def test_four_producers_under_block_lose_nothing_and_end_in_the_jax_states(staging):
    """Four producer threads submit seeded cohorts into a live queue (the
    flusher running, ``block`` so nothing sheds) over a port
    ``MultiTenantCollection``; at drain both conservation laws hold exactly,
    ``submitted - shed == rows_routed``, and the integer states equal the
    JAX package's fed the same rows (sums do not depend on the order)."""
    n, per, rows = 20, 6, 32
    tm = T.MultiTenantCollection([T.Accuracy(**CPU), T.Precision(num_classes=3, average="macro", **CPU)], n,
                                 validate_ids=False, **CPU)
    jm = J.MultiTenantCollection([J.Accuracy(), J.Precision(num_classes=3, average="macro")], n, validate_ids=False)
    q = tserving.AdmissionQueue(tm.update, max_batch=48, max_delay_ms=2.0, capacity_rows=96, policy="block",
                                pad_to_bucket=True, staging=staging)
    cohorts = {w: [_keyed_rows(100 * w + k, rows, n, multiclass=True) for k in range(per)] for w in range(4)}

    def producer(w):
        for ids, preds, target in cohorts[w]:
            q.submit_many(ids, preds, target)

    try:
        threads = [threading.Thread(target=producer, args=(w,)) for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert q.drain(10.0)
    finally:
        q.close(timeout=2.0)
    s = q.stats()
    _assert_invariant(q)
    assert s["shed"] == 0 and s["dispatched"] == 4 * per * rows
    assert s["submitted"] - s["shed"] == tm.tenant_report()["rows_routed"]
    for w in range(4):
        for ids, preds, target in cohorts[w]:
            jm.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
    js, ts = _states(jm), _states(tm)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def test_the_flusher_prefetches_full_cohorts_and_ends_in_the_jax_states():
    """Staged, the flusher running, two full cohorts per submit: each flush
    stages the next full cohort on the staging lane while it dispatches. The
    lane's cohorts reach the target in order, and the integer states equal
    the JAX package's fed the same rows."""
    n, batch, submits = 20, 32, 10
    tm = T.MultiTenantCollection([T.Accuracy(**CPU), T.Precision(num_classes=3, average="macro", **CPU)], n,
                                 validate_ids=False, **CPU)
    jm = J.MultiTenantCollection([J.Accuracy(), J.Precision(num_classes=3, average="macro")], n, validate_ids=False)
    q = tserving.AdmissionQueue(tm.update, max_batch=batch, max_delay_ms=1000.0, staging=True)
    cohorts = [_keyed_rows(500 + k, 2 * batch, n, multiclass=True) for k in range(submits)]
    try:
        for ids, preds, target in cohorts:
            q.submit_many(ids, preds, target)
        assert q.drain(10.0)
    finally:
        q.close(timeout=2.0)
    s = q.stats()
    _assert_invariant(q)
    assert s["shed"] == 0 and s["dispatched"] == 2 * submits * batch and s["last_error"] is None
    assert s["staging"]["prefetched_cohorts"] > 0
    for ids, preds, target in cohorts:
        jm.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
    js, ts = _states(jm), _states(tm)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def test_racing_writers_and_flushers_match_a_serial_referee():
    writers, rows_per, tenants = 4, 150, 16
    rec = _Recorder()
    q = _queue("torch", rec, max_batch=32, capacity_rows=writers * rows_per, staging=True)
    stop = threading.Event()

    def rows_of(w):
        rng = np.random.RandomState(1000 + w)
        return rng.randint(0, tenants, rows_per), rng.randint(0, 1000, rows_per).astype(np.float32)

    def flusher():
        while not stop.is_set():
            q._flush_once("manual")

    def writer(w):
        for t, v in zip(*rows_of(w)):
            q.submit(int(t), np.float32(v))

    flushers = [threading.Thread(target=flusher) for _ in range(2)]
    threads = [threading.Thread(target=writer, args=(w,)) for w in range(writers)]
    for th in flushers + threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    stop.set()
    for th in flushers:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in flushers + threads)
    while q.depth():
        q._flush_once("manual")
    _assert_invariant(q)
    assert q.stats()["dispatched"] == writers * rows_per
    got = np.zeros(tenants)
    for ids, cols in rec.calls:
        np.add.at(got, ids, cols[0])
    want = np.zeros(tenants)
    for w in range(writers):
        t, v = rows_of(w)
        np.add.at(want, t, v)
    np.testing.assert_array_equal(got, want)
    q.close()


def test_conservation_through_faults_under_concurrency():
    writers, rows_per = 4, 100
    rec = _Recorder(fail_times=3)
    q = _queue("torch", rec, max_batch=16, capacity_rows=writers * rows_per, staging=True, quarantine="on")
    stop = threading.Event()

    def flusher():
        while not stop.is_set():
            try:
                q._flush_once("manual")
            except Exception:  # noqa: BLE001 - a flush never raises; asserted below
                stop.set()
                raise

    def writer(w):
        rng = np.random.RandomState(2000 + w)
        for _ in range(rows_per):
            v = np.nan if rng.rand() < 0.05 else float(rng.randint(0, 100))
            q.submit(int(rng.randint(0, 16)), np.float32(v))

    with pytest.warns(UserWarning, match="dispatch failed"):
        flushers = [threading.Thread(target=flusher) for _ in range(2)]
        threads = [threading.Thread(target=writer, args=(w,)) for w in range(writers)]
        for th in flushers + threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        stop.set()
        for th in flushers:
            th.join(timeout=60)
        while q.depth():
            q._flush_once("manual")
    _assert_invariant(q)
    s = q.stats()
    shed = s["shed_by_reason"]
    assert s["submitted"] == writers * rows_per and s["resident"] == 0
    assert s["dispatched"] + shed.get("poisoned", 0) + shed.get("dispatch_error", 0) == s["admitted"]
    assert rec.rows == s["dispatched"]
    q.close()


def test_staging_series_and_counters_surface():
    from metrics_tpu_torch.observability.histogram import HISTOGRAMS

    q = _queue("torch", _Recorder(), max_batch=8, staging=True)
    for i in range(8):
        q.submit(i, np.float32(i))
    q._flush_once("manual")
    q.close()
    assert tserving.SERVING_STATS.counter("staged_cohorts") == 1
    snap = HISTOGRAMS.snapshot()
    assert snap.get("serving_staging_fill_seconds", {}).get("count", 0) == 1
    assert snap.get("serving_staging_occupancy", {}).get("count", 0) == 1


@pytest.mark.parametrize("unit", ["s", "count", "bytes"])
def test_bulk_observation_gives_the_jax_histograms_buckets(unit):
    """The flush observes its per-row histograms in bulk
    (``Log2Histogram.observe_many``); bucket for bucket that is the JAX
    package's histogram observed row by row, edge values included."""
    from metrics_tpu.observability.histogram import Log2Histogram as JHist
    from metrics_tpu_torch.observability.histogram import Log2Histogram as THist

    rng = np.random.RandomState(11)
    special = [0.0, -1.0, np.nan, np.inf, 1e-30, 1e30, 2.0 ** -5, 2.0 ** 3, 0.5, 1.0, np.nextafter(1.0, 2.0)]
    values = np.concatenate([np.asarray(special), rng.lognormal(-4, 3, 500), 2.0 ** rng.randint(-25, 25, 50)])
    jh, th = JHist(unit), THist(unit)
    for v in values:
        jh.observe(v)
    th.observe_many(values)
    th.observe_many(np.empty(0))
    np.testing.assert_array_equal(th.bucket_counts(), jh.bucket_counts())
    assert th.count == jh.count == len(values)
    finite = values[np.isfinite(values)]
    jf, tf = JHist(unit), THist(unit)
    for v in finite:
        jf.observe(v)
    tf.observe_many(finite)
    assert tf.sum == pytest.approx(jf.sum, rel=1e-12)
    for q in (50, 95, 99):
        assert tf.percentile(q) == jf.percentile(q)
