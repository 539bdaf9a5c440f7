"""The port's resilience policies against the JAX package's.

``RetryPolicy``, ``DeadlineBudget`` and ``CircuitBreaker``
(``metrics_tpu_torch/resilience/policies.py``) and the ``resilience.*``
counters go through the same call sequences as the JAX package's; their
schedules, verdicts, states and counters must be equal. The async engine's
retries and the admission queue's breaker are driven on both sides too.
"""
import time

import numpy as np
import pytest

import metrics_tpu.observability as jobs
import metrics_tpu.resilience as jres
import metrics_tpu_torch.observability as tobs
import metrics_tpu_torch.resilience as tres
from metrics_tpu.serving import AdmissionQueue as JQueue
from metrics_tpu.utilities.async_sync import AsyncSyncEngine as JEngine
from metrics_tpu_torch.resilience.policies import PLANE_POLICIES
from metrics_tpu_torch.serving import AdmissionQueue as TQueue
from metrics_tpu_torch.utilities.async_sync import AsyncSyncEngine as TEngine

PKGS = {"jax": (jres, JEngine, JQueue), "torch": (tres, TEngine, TQueue)}


@pytest.fixture(autouse=True)
def clean():
    for obs in (jobs, tobs):
        obs.enable()
        obs.reset()
    jres.reset()
    yield
    jres.reset()
    tres.RESILIENCE_STATS.reset()


def _both(fn):
    """``fn(res, Engine, Queue)`` on each package; the two results."""
    return fn(*PKGS["jax"]), fn(*PKGS["torch"])


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(max_retries=5, backoff_s=0.1, multiplier=2.0, max_backoff_s=0.35),
        dict(max_retries=0, backoff_s=0.0),
        dict(max_retries=3, backoff_s=0.01, multiplier=3.0, max_backoff_s=10.0),
        dict(max_retries=2, backoff_s=0.05, multiplier=1.0),
    ],
)
def test_retry_backoff_schedule_matches(kwargs):
    def run(res, *_):
        p = res.RetryPolicy(**kwargs)
        return [p.backoff(k) for k in range(0, 7)], [p.should_retry(k) for k in range(0, 7)], repr(p)

    jax_out, torch_out = _both(run)
    assert jax_out == torch_out
    if kwargs.get("max_backoff_s") == 0.35:
        assert torch_out[0][1:5] == [0.1, 0.2, 0.35, 0.35]


@pytest.mark.parametrize(
    "bad",
    [dict(max_retries=-1), dict(backoff_s=-0.1), dict(multiplier=0.5)],
)
def test_retry_policy_rejects_what_the_jax_package_rejects(bad):
    for res in (jres, tres):
        with pytest.raises(ValueError):
            res.RetryPolicy(**bad)


def test_with_overrides_maps_legacy_knobs():
    base = tres.RetryPolicy(2, 0.05)
    assert base.with_overrides() is base
    tweaked = base.with_overrides(max_retries=4)
    assert tweaked.max_retries == 4 and tweaked.backoff_s == 0.05
    assert tweaked == tres.RetryPolicy(4, 0.05)
    assert repr(tweaked) == repr(jres.RetryPolicy(2, 0.05).with_overrides(max_retries=4))


def test_retry_sleep_counts_into_telemetry_as_the_jax_package_does():
    def run(res, *_):
        res.RetryPolicy(1, 0.0).sleep(1)
        res.RetryPolicy(1, 0.0).sleep(2)
        return res.RESILIENCE_STATS.counter("policy_retries")

    assert _both(run) == (2, 2)


def test_plane_registry_overrides():
    assert {k: repr(v) for k, v in PLANE_POLICIES.items()} == {
        k: repr(v) for k, v in jres.policies.PLANE_POLICIES.items()
    }
    prev = tres.retry_policy_for("checkpoint")
    try:
        tres.set_retry_policy("checkpoint", tres.RetryPolicy(9, 0.01))
        assert tres.retry_policy_for("checkpoint").max_retries == 9
        assert tres.retry_policy_for("nonsense") == PLANE_POLICIES["async_sync"]
        with pytest.raises(TypeError):
            tres.set_retry_policy("checkpoint", "fast")
    finally:
        tres.set_retry_policy("checkpoint", prev)


def test_async_engine_runs_on_the_unified_retry_policy():
    def run(res, Engine, _):
        engine = Engine(max_retries=2, backoff_s=0.0)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("transient")
            return "ok"

        try:
            future = engine.submit("unified-retry", flaky, on_degraded="retry")
            value = future.result(timeout=10.0)
            out = (repr(engine.retry_policy), value, len(calls), future.attempts,
                   res.RESILIENCE_STATS.counter("policy_retries"), engine.summary()["retries"])
        finally:
            engine.shutdown()
        explicit = Engine(retry_policy=res.RetryPolicy(0, 0.0))
        try:
            failing = explicit.submit("no-retries", lambda: 1 / 0, on_degraded="retry")
            assert failing.exception(timeout=10.0) is not None
            return out + (failing.attempts,)
        finally:
            explicit.shutdown()

    jax_out, torch_out = _both(run)
    assert jax_out == torch_out
    assert torch_out[1:] == ("ok", 3, 3, 2, 2, 1)


def test_deadline_budget_is_shared_across_steps():
    budget = tres.DeadlineBudget(0.2)
    first = budget.remaining()
    time.sleep(0.05)
    second = budget.remaining()
    assert second < first <= 0.2
    assert budget.remaining_ms(floor_ms=1.0) >= 1
    assert not budget.expired
    time.sleep(0.2)
    assert budget.expired and budget.remaining() == 0.0
    with pytest.raises(tres.DeadlineExhausted):
        budget.check("subgroup round")
    assert tres.RESILIENCE_STATS.counter("deadline_exhausted") == 1


def test_unbounded_budget():
    for res in (jres, tres):
        budget = res.DeadlineBudget(None)
        assert budget.remaining() is None and budget.remaining_ms() is None
        assert not budget.expired
        budget.check()
        with pytest.raises(ValueError):
            res.DeadlineBudget(0)


def _breaker_trace(res, steps):
    """Run ``steps`` on a fresh breaker: each ``"fail"``/``"ok"`` records, each
    ``"allow"`` asks, each ``"sleep"`` waits out the window; the states and
    verdicts in order, then the two breaker counters."""
    cb = res.CircuitBreaker(failure_threshold=2, reset_after_s=0.05)
    out = []
    for step in steps:
        if step == "fail":
            cb.record_failure()
        elif step == "ok":
            cb.record_success()
        elif step == "sleep":
            time.sleep(0.06)
        elif step == "allow":
            out.append(cb.allow())
        out.append(cb.state)
    return out + [res.RESILIENCE_STATS.counter("breaker_opens"), res.RESILIENCE_STATS.counter("breaker_short_circuits")]


@pytest.mark.parametrize(
    "steps",
    [
        # trips after two consecutive failures, then one half-open probe
        ["allow", "fail", "allow", "fail", "allow", "sleep", "allow", "allow", "ok", "allow"],
        # a failed probe re-arms the timer
        ["fail", "fail", "sleep", "allow", "fail", "allow", "sleep", "allow"],
        # a success resets the consecutive count
        ["fail", "ok", "fail", "allow", "fail", "allow"],
        # reset closes an open breaker
        ["fail", "fail", "allow", "ok", "allow"],
    ],
)
def test_breaker_states_match_the_jax_package(steps):
    jax_out = _breaker_trace(jres, steps)
    torch_out = _breaker_trace(tres, steps)
    assert jax_out == torch_out


def test_breaker_rejects_bad_arguments():
    for res in (jres, tres):
        with pytest.raises(ValueError):
            res.CircuitBreaker(failure_threshold=0)
        with pytest.raises(ValueError):
            res.CircuitBreaker(reset_after_s=0)
    cb = tres.CircuitBreaker(failure_threshold=1, reset_after_s=1.0)
    cb.record_failure()
    cb.reset()
    assert cb.state == "closed" and "closed" in repr(cb)


def test_queue_breaker_sheds_with_exact_reason():
    """An open breaker sheds whole cohorts under ``breaker_open`` without
    calling the target; the half-open probe's success closes it; the ledgers
    of both packages are equal throughout."""

    def run(res, _, Queue):
        calls = []
        fail = [True]

        def target(ids, *cols):
            calls.append(len(ids))
            if fail[0]:
                raise RuntimeError("downstream sick")

        cb = res.CircuitBreaker(failure_threshold=1, reset_after_s=0.05)
        extra = {} if Queue is JQueue else {"device": "cpu"}
        q = Queue(target, max_batch=4, quarantine="off", breaker=cb, start=False, **extra)
        q.submit_many([0, 1], np.array([0.1, 0.2], np.float32))
        with pytest.warns(UserWarning, match="dispatch failed"):
            q.flush()
        q.submit_many([2, 3], np.array([0.3, 0.4], np.float32))
        q.flush()
        first = dict(q.stats()["shed_by_reason"])
        fail[0] = False
        time.sleep(0.06)
        q.submit_many([4, 5], np.array([0.5, 0.6], np.float32))
        q.flush()
        stats = q.stats()
        q.close()
        return first, len(calls), stats["dispatched"], cb.state, stats["submitted"] - stats["shed"]

    jax_out, torch_out = _both(run)
    assert jax_out == torch_out == ({"dispatch_error": 2, "breaker_open": 2}, 2, 2, "closed", 2)


def test_resilience_section_and_prometheus_match():
    for res in (jres, tres):
        res.RetryPolicy(1, 0.0).sleep(1)
        cb = res.CircuitBreaker(failure_threshold=1, reset_after_s=10.0)
        cb.record_failure()
        cb.allow()
    jsec, tsec = jobs.snapshot()["resilience"], tobs.snapshot()["resilience"]
    assert tsec == jsec
    assert tsec["policy_retries"] == 1 and tsec["breaker_opens"] == 1 and tsec["breaker_short_circuits"] == 1
    text = tobs.render_prometheus()
    for line in ("metrics_tpu_resilience_policy_retries_total 1", "metrics_tpu_resilience_breaker_opens_total 1",
                 "metrics_tpu_resilience_membership_epoch 0", "# TYPE metrics_tpu_resilience_breaker_opens_total counter"):
        assert line in text


def test_telemetry_off_counts_no_policy_decision():
    tobs.disable()
    try:
        tres.RetryPolicy(1, 0.0).sleep(1)
        assert tres.RESILIENCE_STATS.counter("policy_retries") == 0
        assert tres.RESILIENCE_STATS.summary() == {}
    finally:
        tobs.enable()
