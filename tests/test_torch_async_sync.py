"""The port's background sync engine and ``compute_async`` against the JAX package's.

``AsyncSyncEngine`` (``metrics_tpu_torch/utilities/async_sync.py``) is held
against the JAX package's engine on the same job sequences: generations,
FIFO order, coalescing, the retry and stale policies on rounds that raise
or time out, counters and ``sync`` events. ``Metric.compute_async`` and
``MetricCollection.compute_async`` (and the keyed wrappers, through their
``clone()``) must resolve to what ``compute()`` gives at the snapshot, on
the same seeded numpy batches as the JAX package's ``compute_async``, and
later updates must not change the result.

Elsewhere: the engine's degraded rounds (peers a published straggler
report flags) against the JAX engine's are in
``tests/test_torch_aggregate_fleet.py``, and over two gloo processes in
``tests/test_torch_sync_gloo.py``. The quorum round narrowed to a subgroup
(transport overrides, the membership epoch) is in
``tests/test_torch_faults_membership.py`` and, over four gloo processes, in
``tests/test_torch_hierarchical_sync.py``.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.observability as jobs
import metrics_tpu_torch as T
import metrics_tpu_torch.observability as tobs
from metrics_tpu.utilities import async_sync as jas
from metrics_tpu_torch.utilities import async_sync as tas

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def clean():
    for obs in (jobs, tobs):
        obs.enable()
        obs.reset()
    yield
    tas.get_engine().drain(timeout=10.0)
    jas.get_engine().drain(timeout=10.0)


def _engines():
    return jas.AsyncSyncEngine(), tas.AsyncSyncEngine()


def _shutdown(*engines):
    for e in engines:
        e.shutdown(timeout=5.0)


def _summary(engine):
    s = engine.summary()
    s.pop("engine_alive")
    return s


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_engine_generations_and_policy_validation_match():
    outs = []
    for engine in _engines():
        try:
            f1 = engine.submit("k", lambda: 1)
            f2 = engine.submit("k", lambda: 2)
            g = engine.submit("other", lambda: 3)
            outs.append(((f1.generation, f2.generation, g.generation), f1.result(5.0), f2.result(5.0),
                         engine.last_generation("k"), engine.last_generation("missing")))
            with pytest.raises(ValueError, match="on_degraded"):
                engine.submit("k", lambda: 3, on_degraded="panic")
            assert engine.drain(5.0)
            outs.append(_summary(engine))
        finally:
            _shutdown(engine)
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert outs[2][0] == (1, 2, 1) and outs[3]["submitted"] == 3 and outs[3]["completed"] == 3


def test_engine_fifo_order_preserved():
    engine = tas.AsyncSyncEngine()
    order = []
    try:
        futures = [engine.submit("k", lambda i=i: order.append(i) or i) for i in range(8)]
        assert [f.result(5.0) for f in futures] == list(range(8))
        assert order == list(range(8))
    finally:
        _shutdown(engine)


@pytest.mark.parametrize("engine_mod", [jas, tas], ids=["jax", "torch"])
def test_timeout_error_type_is_async_sync_error(engine_mod):
    engine = engine_mod.AsyncSyncEngine()
    try:
        fut = engine.submit("k", lambda: time.sleep(2.0), round_timeout_s=0.05, max_retries=0)
        err = fut.exception(timeout=10.0)
        assert isinstance(err, engine_mod.SyncTimeout) and isinstance(err, engine_mod.AsyncSyncError)
        assert engine.summary()["timeouts"] == 1 and engine.summary()["failed"] == 1
    finally:
        _shutdown(engine)


def test_future_result_times_out_while_in_flight():
    engine = tas.AsyncSyncEngine()
    gate = threading.Event()
    try:
        fut = engine.submit("k", lambda: gate.wait(5.0))
        with pytest.raises(TimeoutError, match="still in flight"):
            fut.result(timeout=0.01)
        assert not fut.done() and "pending" in repr(fut)
        gate.set()
        assert fut.result(timeout=5.0) is True and "done" in repr(fut)
    finally:
        gate.set()
        _shutdown(engine)


def test_submit_coalesce_matches_the_jax_package():
    outs = []
    for engine in _engines():
        gate = threading.Event()
        ran = []

        def slow():
            gate.wait(5.0)
            ran.append(1)
            return "value"

        try:
            first = engine.submit("k", slow, coalesce=True)
            second = engine.submit("k", slow, coalesce=True)
            joined = second is first
            gate.set()
            value = first.result(timeout=5.0)
            assert engine.drain(5.0)
            third = engine.submit("k", lambda: "fresh", coalesce=True)
            outs.append((joined, first.generation, value, len(ran), third is first, third.generation,
                         third.result(timeout=5.0), engine.summary()["coalesced"], engine.summary()["submitted"]))
        finally:
            gate.set()
            _shutdown(engine)
    assert outs[0] == outs[1] == (True, 1, "value", 1, False, 2, "fresh", 1, 2)


def test_submit_without_coalesce_always_queues():
    engine = tas.AsyncSyncEngine()
    try:
        a, b = engine.submit("k", lambda: 1), engine.submit("k", lambda: 2)
        assert a is not b and (a.generation, b.generation) == (1, 2)
        assert a.result(timeout=5.0) == 1 and b.result(timeout=5.0) == 2
        assert engine.summary()["coalesced"] == 0
    finally:
        _shutdown(engine)


def _flaky(fail_first):
    calls = []

    def thunk():
        calls.append(1)
        if len(calls) <= fail_first:
            raise OSError("link down")
        return len(calls)

    return thunk


@pytest.mark.parametrize(
    "policy, fail_first, max_retries",
    [("retry", 1, 2), ("retry", 2, 2), ("retry", 5, 2), ("quorum", 1, 1), ("quorum", 3, 1), ("retry", 0, 0)],
)
def test_retry_policies_match_the_jax_package(policy, fail_first, max_retries):
    outs = []
    for engine in _engines():
        try:
            fut = engine.submit("k", _flaky(fail_first), on_degraded=policy, max_retries=max_retries, backoff_s=0.001)
            err = fut.exception(timeout=10.0)
            outs.append((type(err).__name__ if err else None, None if err else fut.result(), fut.attempts,
                         fut.stale, _summary(engine)))
        finally:
            _shutdown(engine)
    jax_out, torch_out = outs
    # the JAX engine counts no degraded rounds on one process either
    assert jax_out == torch_out


def test_stale_policy_serves_last_completed_generation():
    outs = []
    for engine, events in zip(_engines(), (jobs.EVENTS, tobs.EVENTS)):
        try:
            first = engine.submit("k", lambda: "gen1", on_degraded="stale")
            assert first.result(timeout=5.0) == "gen1" and not first.stale
            fut = engine.submit("k", _flaky(10), on_degraded="stale")
            value = fut.result(timeout=5.0)
            stale_events = [e.payload for e in events.events() if e.kind == "sync" and e.payload.get("outcome") == "stale"]
            outs.append((value, fut.stale, fut.generation, _summary(engine), stale_events[-1]["served_generation"],
                         stale_events[-1]["stale"]))
        finally:
            _shutdown(engine)
    assert outs[0] == outs[1]
    assert outs[1][:3] == ("gen1", True, 2) and outs[1][3]["stale_serves"] == 1


@pytest.mark.parametrize("engine_mod", [jas, tas], ids=["jax", "torch"])
def test_stale_policy_without_history_fails(engine_mod):
    engine = engine_mod.AsyncSyncEngine()
    try:
        fut = engine.submit("k", _flaky(10), on_degraded="stale")
        with pytest.raises(engine_mod.AsyncSyncError, match="failed after 1 attempt"):
            fut.result(timeout=5.0)
    finally:
        _shutdown(engine)


def test_stale_policy_on_a_round_that_times_out():
    """The ``stale`` policy on a timed-out round serves the last completed
    generation at once, as the JAX engine does."""
    outs = []
    for engine in _engines():
        release = threading.Event()
        try:
            assert engine.submit("k", lambda: 7).result(timeout=5.0) == 7
            fut = engine.submit("k", lambda: release.wait(5.0), on_degraded="stale", round_timeout_s=0.05)
            outs.append((fut.result(timeout=5.0), fut.stale, engine.summary()["timeouts"],
                         engine.summary()["stale_serves"]))
        finally:
            release.set()
            _shutdown(engine)
    assert outs[0] == outs[1] == (7, True, 1, 1)


def test_round_timeout_orphans_a_hung_round_and_the_retry_succeeds():
    engine = tas.AsyncSyncEngine()
    release = threading.Event()
    calls = []

    def hung_then_healthy():
        calls.append(1)
        if len(calls) == 1:
            release.wait(5.0)
            return "orphan"
        return "fresh"

    try:
        fut = engine.submit("k", hung_then_healthy, round_timeout_s=0.1, max_retries=1, backoff_s=0.001)
        assert fut.result(timeout=10.0) == "fresh" and fut.attempts == 2
        s = engine.summary()
        assert s["timeouts"] == 1 and s["retries"] == 1 and s["completed"] == 1
    finally:
        release.set()
        _shutdown(engine)


def test_engine_reset_clears_generations_counters_and_retained_values():
    outs = []
    for engine in _engines():
        try:
            engine.submit("k", lambda: "a").result(5.0)
            engine.submit("k", lambda: "b").result(5.0)
            before = engine.last_generation("k")
            engine.reset()
            after = (engine.last_generation("k"), _summary(engine))
            fut = engine.submit("k", _flaky(10), on_degraded="stale")
            outs.append((before, after, type(fut.exception(5.0)).__name__, engine.submit("k", lambda: 1).generation))
        finally:
            _shutdown(engine)
    assert outs[0] == outs[1]
    assert outs[1][0] == 2 and outs[1][1][0] == 0 and outs[1][1][1]["submitted"] == 0
    assert outs[1][2] == "AsyncSyncError" and outs[1][3] == 2  # nothing stale to serve after the reset


def test_engine_drain_times_out_and_lanes_are_separate():
    engine = tas.AsyncSyncEngine()
    gate = threading.Event()
    try:
        engine.submit("k", lambda: gate.wait(5.0))
        assert engine.drain(0.02) is False
        gate.set()
        assert engine.drain(5.0) is True
    finally:
        gate.set()
        _shutdown(engine)
    assert tas.get_engine() is tas.get_engine("default")
    assert tas.staging_lane() is tas.get_engine("staging") is not tas.get_engine()
    assert tas.get_engine("checkpoint") is not tas.staging_lane()


def test_async_sync_section_events_and_prometheus_match():
    for mod in (jas, tas):
        eng = mod.get_engine()
        eng.reset()
        eng.submit("snap", lambda: 1).result(5.0)
        eng.submit("snap", _flaky(10), on_degraded="retry", max_retries=1, backoff_s=0.001).exception(5.0)
        assert eng.drain(5.0)
    jsec, tsec = jobs.snapshot()["async_sync"], tobs.snapshot()["async_sync"]
    assert tsec == jsec
    assert tsec["submitted"] == 2 and tsec["failed"] == 1 and tsec["retries"] == 1
    jsync = [(e.payload["outcome"], e.payload["generation"], e.payload["attempts"])
             for e in jobs.EVENTS.events() if e.kind == "sync"]
    tsync = [(e.payload["outcome"], e.payload["generation"], e.payload["attempts"])
             for e in tobs.EVENTS.events() if e.kind == "sync"]
    assert tsync == jsync == [("completed", 1, 1), ("failed", 2, 2)]
    text = tobs.render_prometheus()
    assert "# TYPE metrics_tpu_async_sync_submitted_total counter" in text
    assert "metrics_tpu_async_sync_failed_total 1" in text and "metrics_tpu_async_sync_in_flight 0" in text


# ---------------------------------------------------------------------------
# compute_async
# ---------------------------------------------------------------------------


def _batches(seed, n=5, rows=32, c=4):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        logits = rng.randn(rows, c).astype(np.float32)
        preds = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        out.append((preds.astype(np.float32), rng.randint(0, c, rows)))
    return out


def _values(v):
    if isinstance(v, dict):
        return {k: np.asarray(x, np.float64) for k, x in v.items()}
    return np.asarray(v, np.float64)


def _assert_close(a, b):
    a, b = _values(a), _values(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6)
    else:
        np.testing.assert_allclose(a, b, atol=1e-6)


def _metric(pkg, kind):
    kw = {} if pkg is J else CPU
    if kind == "accuracy":
        return pkg.Accuracy(**kw)
    if kind == "precision":
        return pkg.Precision(num_classes=4, average="macro", **kw)
    if kind == "confmat":
        return pkg.ConfusionMatrix(num_classes=4, **kw)
    return pkg.MetricCollection([pkg.Accuracy(**kw), pkg.Precision(num_classes=4, average="macro", **kw),
                                 pkg.Recall(num_classes=4, average="macro", **kw)])


@pytest.mark.parametrize("kind", ["accuracy", "precision", "confmat", "collection"])
def test_compute_async_equals_compute_at_the_snapshot(kind):
    batches = _batches(1)
    jm, tm = _metric(J, kind), _metric(T, kind)
    for preds, target in batches[:3]:
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    want_now = tm.compute()
    jfut, tfut = jm.compute_async(), tm.compute_async()
    # later updates of the live metric leave the snapshot's result alone
    for preds, target in batches[3:]:
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    got = tfut.result(timeout=10.0)
    assert tfut.done() and not tfut.stale and tfut.generation == 1
    _assert_close(got, want_now)
    _assert_close(got, jfut.result(timeout=10.0))
    _assert_close(tm.compute(), jm.compute())
    with pytest.raises(AssertionError):
        _assert_close(got, tm.compute())


def test_compute_async_generations_count_per_key_and_the_counter_is_recorded():
    acc = T.Accuracy(**CPU)
    preds, target = _batches(2)[0]
    acc.update(torch.from_numpy(preds), torch.from_numpy(target))
    futs = [acc.compute_async() for _ in range(3)]
    assert [f.generation for f in futs] == [1, 2, 3]
    for f in futs:
        _assert_close(f.result(timeout=10.0), acc.compute())
    assert tas.get_engine().last_generation(acc.telemetry_key) == 3
    counters = tobs.snapshot()["metrics"][acc.telemetry_key]["counters"]
    assert counters["compute_async_calls"] == 3
    coll = _metric(T, "collection")
    coll.update(torch.from_numpy(preds), torch.from_numpy(target))
    value = coll.compute()
    assert isinstance(value, dict) and not hasattr(value, "result")
    coll.compute_async().result(timeout=10.0)
    assert tobs.snapshot()["metrics"][coll.telemetry_key]["counters"]["compute_async_calls"] == 1


def test_compute_async_of_the_keyed_wrappers():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 6, 40)
    preds = rng.rand(40).astype(np.float32)
    target = (rng.rand(40) < preds).astype(np.int64)
    km = T.KeyedMetric(T.Accuracy(**CPU), num_tenants=6, **CPU)
    jkm = J.KeyedMetric(J.Accuracy(), num_tenants=6)
    km.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
    jkm.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
    fut = km.compute_async()
    km.update(torch.from_numpy(ids), torch.from_numpy(1 - preds), torch.from_numpy(target))
    _assert_close(fut.result(timeout=10.0), jkm.compute_async().result(timeout=10.0))


def test_compute_async_with_the_stale_policy_on_a_failing_round(monkeypatch):
    acc = T.Accuracy(**CPU)
    preds, target = _batches(4)[0]
    acc.update(torch.from_numpy(preds), torch.from_numpy(target))
    first = acc.compute_async(on_degraded="stale").result(timeout=10.0)
    acc.update(torch.from_numpy(preds[:5]), torch.from_numpy((target[:5] + 1) % 4))

    def broken(self):
        raise OSError("link down")

    # the clones the engine computes rebuild their compute from the class
    monkeypatch.setattr(T.Accuracy, "compute", broken)
    stale = acc.compute_async(on_degraded="stale")
    assert float(stale.result(timeout=10.0)) == float(first)
    assert stale.stale is True and stale.generation == 2


def test_compute_async_retries_then_fails_with_the_engine_error(monkeypatch):
    acc = T.Accuracy(**CPU)
    preds, target = _batches(5)[0]
    acc.update(torch.from_numpy(preds), torch.from_numpy(target))
    calls = []
    real = T.Accuracy.compute

    def flaky(self):
        calls.append(1)
        if len(calls) < 2:
            raise OSError("transient")
        return real(self)

    monkeypatch.setattr(T.Accuracy, "compute", flaky)
    fut = acc.compute_async(max_retries=2, backoff_s=0.001)
    assert fut.result(timeout=10.0) is not None and fut.attempts == 2
    calls.clear()
    fut = acc.compute_async(max_retries=0, backoff_s=0.001)
    with pytest.raises(tas.AsyncSyncError, match="transient"):
        fut.result(timeout=10.0)
