"""The resilience plane against the JAX package: fault plans, the membership
epoch, the phi-accrual detector and their telemetry.

Counterparts of ``tests/resilience/test_faults.py``,
``test_detector_membership.py`` and ``test_telemetry.py``. Each case runs
the same call sequence (same seeds, same fake clock) on both packages'
planes and compares what comes out exactly: fired schedules, raised types
and messages, corrupted bytes, views, phi values, suspects and counters.
The seams the port wires (the admission queue's dispatch, the async
engine's attempts, the scheduler's epoch edge) are driven on both packages'
objects too.
"""
import math
import time

import numpy as np
import pytest
import torch

import metrics_tpu.resilience as jres
import metrics_tpu_torch.resilience as tres
from metrics_tpu.observability import export as jexport
from metrics_tpu_torch.observability import export as texport

PLANES = {"jax": jres, "torch": tres}


@pytest.fixture(autouse=True)
def _clean():
    for res in PLANES.values():
        res.reset()
    yield
    for res in PLANES.values():
        res.reset()


def _both(scenario):
    """``scenario(res)`` on both planes; the two results."""
    return scenario(jres), scenario(tres)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as err:  # noqa: BLE001 - compared by type name and text
        return (type(err).__name__, str(err))


# -- fault plans -------------------------------------------------------------------


def test_the_seams_and_modes_and_exports_equal_the_jax_package():
    assert tres.SEAMS == jres.SEAMS and tres.MODES == jres.MODES
    assert set(tres.__all__) == set(jres.__all__)


@pytest.mark.parametrize("kwargs", [
    {"seam": "nonsense.seam", "mode": "error"},
    {"seam": "serving.dispatch", "mode": "explode"},
    {"seam": "serving.dispatch", "mode": "error", "at": [0], "prob": 0.5},
    {"seam": "serving.dispatch", "mode": "error", "prob": 1.5},
])
def test_an_invalid_spec_raises_as_in_the_jax_package(kwargs):
    j, t = _both(lambda res: _outcome(lambda: repr(res.FaultSpec(**kwargs))))
    assert j == t and j[0] == "ValueError"


def test_no_plan_is_a_noop():
    assert _both(lambda res: (res.current_fault_plan(), res.maybe_fault("serving.dispatch"))) == ((None, None),) * 2


def _fire_sequence(res, specs, seam, hits, seed=0, **ctx):
    plan = res.FaultPlan(seed, [res.FaultSpec(**s) for s in specs])
    outcomes = []
    with res.fault_plan(plan):
        for _ in range(hits):
            outcomes.append(_outcome(lambda: res.maybe_fault(seam, **ctx)))
    return outcomes, plan.fired(), plan.report()


@pytest.mark.parametrize("specs,seam,hits", [
    ([{"seam": "serving.dispatch", "mode": "error", "at": [1, 3]}], "serving.dispatch", 5),
    ([{"seam": "transport.payload", "mode": "drop", "at": [0]}], "transport.payload", 2),
    ([{"seam": "checkpoint.before_rename", "mode": "crash", "at": [0, 2]}], "checkpoint.before_rename", 3),
    ([{"seam": "async.attempt", "mode": "error", "times": 2}], "async.attempt", 5),
    ([{"seam": "async.attempt", "mode": "error", "prob": 0.5}], "async.attempt", 32),
    ([{"seam": "async.attempt", "mode": "error", "prob": 0.25, "times": 3},
      {"seam": "async.attempt", "mode": "delay", "at": [5], "delay_s": 0.0}], "async.attempt", 40),
])
def test_a_schedule_fires_at_the_jax_package_hits(specs, seam, hits):
    j, t = _both(lambda res: _fire_sequence(res, specs, seam, hits, seed=17))
    assert j == t
    assert any(o[0] != "ok" for o in j[0])


@pytest.mark.parametrize("seed", [0, 1, 2, 1234])
def test_a_prob_schedule_is_the_jax_package_pattern_for_its_seed(seed):
    specs = [{"seam": "async.attempt", "mode": "error", "prob": 0.5}]
    j, t = _both(lambda res: [o[0] for o in _fire_sequence(res, specs, "async.attempt", 48, seed=seed)[0]])
    assert j == t


def test_process_scoped_specs_count_per_process_as_in_the_jax_package():
    def scenario(res):
        plan = res.FaultPlan(0, [res.FaultSpec("transport.descriptor", "error", at=[0], process=1)])
        out = []
        with res.fault_plan(plan):
            for process in (0, 1, 0, 1):
                out.append(_outcome(lambda: res.maybe_fault("transport.descriptor", process=process, leaves=3)))
        return out, plan.hits(), plan.fired()

    j, t = _both(scenario)
    assert j == t and j[1] == {"transport.descriptor@0": 2, "transport.descriptor@1": 2}


def test_the_corruptor_flips_the_jax_package_bytes():
    data = np.arange(4096, dtype=np.int32)

    def scenario(res):
        plan = res.FaultPlan(3, [res.FaultSpec("transport.payload", "corrupt", at=[0, 1])])
        with res.fault_plan(plan):
            return [res.maybe_fault("transport.payload").corrupt(data) for _ in range(2)]

    j, t = _both(scenario)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, data)


def test_a_delay_sleeps_and_fault_plan_restores_the_previous_plan():
    outer = tres.FaultPlan(0, [tres.FaultSpec("subgroup.exchange", "delay", at=[0], delay_s=0.05)])
    inner = tres.FaultPlan(1)
    with tres.fault_plan(outer):
        t0 = time.perf_counter()
        assert tres.maybe_fault("subgroup.exchange") is None
        assert time.perf_counter() - t0 >= 0.045
        with tres.fault_plan(inner):
            assert tres.current_fault_plan() is inner
        assert tres.current_fault_plan() is outer
    assert tres.current_fault_plan() is None
    with pytest.raises(TypeError):
        tres.install_fault_plan("plan")


def test_injected_faults_count_and_land_on_the_timeline_as_in_the_jax_package():
    from metrics_tpu import observability as jobs
    from metrics_tpu_torch import observability as tobs

    def scenario(res, obs):
        obs.reset()
        obs.enable()
        plan = res.FaultPlan(5, [res.FaultSpec("serving.dispatch", "error", at=[0, 2]),
                                 res.FaultSpec("async.attempt", "delay", at=[1], delay_s=0.0)])
        with res.fault_plan(plan):
            for _ in range(3):
                _outcome(lambda: res.maybe_fault("serving.dispatch", rows=8))
                _outcome(lambda: res.maybe_fault("async.attempt", key="k", attempt=1))
        snap = obs.snapshot()
        events = [(e.kind, e.metric, e.payload.get("path"), e.payload.get("mode"), e.payload.get("hit"))
                  for e in obs.EVENTS.events() if e.kind == "resilience"]
        return snap["resilience"], events

    j = scenario(jres, jobs)
    t = scenario(tres, tobs)
    assert j == t
    assert j[0]["faults_injected"] == 3 and j[0]["faults_by_seam"] == {"serving.dispatch:error": 2,
                                                                       "async.attempt:delay": 1}


# -- the membership epoch -------------------------------------------------------------


def test_membership_transitions_equal_the_jax_package():
    def scenario(res):
        m = res.Membership(world=4)
        out = [m.current()]
        out.append(m.mark_failed(2, reason="test"))
        out.append(m.mark_failed(2))  # idempotent: no bump
        out.append(m.mark_failed(0))
        out.append(_outcome(lambda: m.mark_failed(9)))
        out.append(_outcome(lambda: m.mark_failed(1) and m.mark_failed(3)))  # would empty the alive set
        out.append(m.rejoin(2))
        out.append(m.mark_recovered(2))  # idempotent
        out.append((m.epoch, m.alive(), m.dead(), m.is_alive(2), m.summary()))
        out.append([(t["epoch"], t["kind"], t["peer"], t["reason"]) for t in m.transitions()])
        m.reset(world=2)
        out.append(m.current())
        return [tuple(v) if isinstance(v, tuple) else v for v in out]

    j, t = _both(scenario)
    assert j == t
    assert j[-1] == (0, (0, 1), ())


def test_the_global_membership_feeds_the_epoch_counters_as_in_the_jax_package():
    def scenario(res):
        res.MEMBERSHIP.reset(world=3)
        res.MEMBERSHIP.mark_failed(1, reason="x")
        res.MEMBERSHIP.mark_recovered(1)
        return res.current_epoch(), res.alive_processes(), res.dead_processes(), res.summary()

    j, t = _both(scenario)
    assert j == t and j[0] == 2 and j[3]["epoch_transitions"] == 2


# -- the phi-accrual detector ------------------------------------------------------------


class _Clock:
    def __init__(self) -> None:
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def _detector_run(res, intervals, silence, fail_after=3, auto_rejoin=False):
    clock = _Clock()
    membership = res.Membership(world=3)
    det = res.FailureDetector(membership=membership, fail_after=fail_after, clock=clock, auto_rejoin=auto_rejoin)
    for dt in intervals:
        clock.now += dt
        det.heartbeat(2)
        det.observe_round([1], ok=True)
    clock.now += silence
    phis = [det.phi(p) for p in (1, 2)]
    suspects = det.suspects()
    view = det.promote()
    det.observe_round([1, 2], ok=True)  # both heard again
    clock.now += 0.01
    view2 = det.promote()
    return phis, suspects, tuple(view), tuple(view2), det.report()["peers"]


@pytest.mark.parametrize("intervals,silence", [
    ([0.1] * 20, 0.15), ([0.1] * 20, 2.0), ([0.05, 0.2, 0.1, 0.3, 0.15] * 4, 1.0), ([0.1, 0.1], 0.5)])
@pytest.mark.parametrize("auto_rejoin", [False, True])
def test_phi_suspects_and_promotion_equal_the_jax_package(intervals, silence, auto_rejoin):
    j, t = _both(lambda res: _detector_run(res, intervals, silence, auto_rejoin=auto_rejoin))
    assert j[1:] == t[1:]
    for a, b in zip(j[0], t[0]):
        assert (math.isinf(a) and math.isinf(b)) or a == pytest.approx(b, rel=1e-12, abs=1e-12)


def test_failed_rounds_strike_and_promote_as_in_the_jax_package():
    def scenario(res):
        membership = res.Membership(world=3)
        det = res.FailureDetector(membership=membership, fail_after=2, clock=_Clock())
        out = []
        for ok in (False, True, False, False):
            det.observe_round([2], ok=ok)
            out.append((det.suspects(), tuple(det.promote())))
        return out, membership.transitions()[-1]["reason"]

    j, t = _both(scenario)
    assert j == t and j[0][-1][1][2] == (2,)


def test_a_published_straggler_report_strikes_the_flagged_peer():
    from metrics_tpu_torch.observability import tracing

    tres.DETECTOR.reset()
    fleet = {"processes": [{"process": p, "offset_s": 0.0, "spans": []} for p in range(2)]}
    report = tracing.straggler_report(fleet, publish=False)
    assert report["flagged"] == []
    tres.note_straggler_report([1])
    assert tres.DETECTOR.report()["peers"][1]["strikes"] == 1
    jres.note_straggler_report([1])
    assert jres.DETECTOR.report()["peers"][1]["strikes"] == 1


def test_invalid_detector_arguments_raise_as_in_the_jax_package():
    for kwargs in ({"phi_threshold": 0}, {"fail_after": 0}):
        j, t = _both(lambda res: _outcome(lambda: res.FailureDetector(**kwargs)))
        assert j == t and j[0] == "ValueError"


# -- the seams the port wires ---------------------------------------------------------------


def test_the_dispatch_seam_sheds_an_errored_cohort_as_in_the_jax_package():
    from metrics_tpu.serving import AdmissionQueue as JQueue
    from metrics_tpu_torch.serving import AdmissionQueue as TQueue

    def scenario(res, make):
        got = []
        q = make(lambda ids, x: got.append(np.asarray(ids).copy()))
        plan = res.FaultPlan(0, [res.FaultSpec("serving.dispatch", "error", at=[1])])
        with res.fault_plan(plan):
            for k in range(3):
                q.submit_many(np.arange(4) + 4 * k, np.ones(4, np.float32))
                q.flush()
        s = q.stats()
        q.close()
        return [g.tolist() for g in got], s["shed_by_reason"], s["dispatched"], plan.fired()

    j = scenario(jres, lambda fn: JQueue(fn, max_batch=8, start=False))
    t = scenario(tres, lambda fn: TQueue(fn, max_batch=8, start=False, device="cpu"))
    assert j == t and j[1] == {"dispatch_error": 4} and j[2] == 8


def test_an_engine_attempt_fault_retries_and_the_epoch_rides_the_events():
    from metrics_tpu.utilities.async_sync import AsyncSyncEngine as JEngine
    from metrics_tpu_torch import observability as tobs
    from metrics_tpu_torch.utilities.async_sync import AsyncSyncEngine as TEngine

    def scenario(res, engine_cls):
        res.MEMBERSHIP.reset(world=2)
        res.MEMBERSHIP.mark_failed(1)
        engine = engine_cls(max_retries=2, backoff_s=0.001)
        plan = res.FaultPlan(0, [res.FaultSpec("async.attempt", "error", at=[0])])
        with res.fault_plan(plan):
            quorum = engine.submit("k", lambda: 7, on_degraded="quorum").result(timeout=10)
            stale = engine.submit("k", lambda: 8, on_degraded="stale")
            stale_value = stale.result(timeout=10)
        summary = engine.summary()
        engine.shutdown()
        return (quorum, stale_value, stale.stale, {k: summary[k] for k in (
            "completed", "retries", "quorum_syncs", "degraded_rounds", "stale_serves")}, plan.fired())

    tobs.enable()
    j, t = scenario(jres, JEngine), scenario(tres, TEngine)
    assert j == t and j[3]["quorum_syncs"] == 1 and j[3]["retries"] == 1 and j[2] is True
    events = [e.payload for e in tobs.EVENTS.events() if e.kind == "sync" and e.payload.get("path") == "async"]
    assert events and all(p["membership_epoch"] == 1 for p in events)
    assert any(p.get("outcome") == "quorum" and p.get("quorum") == [0] for p in events)


def test_a_membership_transition_expires_the_scheduler_cache():
    import metrics_tpu_torch as T

    m = T.KeyedMetric(T.Accuracy(device="cpu"), 8, validate_ids=False, device="cpu")
    svc = T.SLOScheduler(m, device="cpu", start=False, max_staleness_s=60.0)
    svc.submit_many(np.arange(4), np.ones(4, np.float32), np.ones(4, np.int32))
    svc.read(max_staleness_s=0.0)
    assert svc.report()["cache_epoch"] == 0
    tres.MEMBERSHIP.reset(world=2)
    tres.MEMBERSHIP.mark_failed(1)
    before = svc.read(np.arange(4))  # the epoch-0 entry expired: a refresh under epoch 1
    assert svc.report()["membership_epoch"] == 1 and svc.report()["cache_epoch"] == 1
    np.testing.assert_array_equal(np.asarray(before), np.ones(4))
    svc.close()


def test_the_resilience_prometheus_family_renders_as_in_the_jax_package():
    def scenario(res, export):
        res.MEMBERSHIP.reset(world=3)
        res.MEMBERSHIP.mark_failed(2)
        plan = res.FaultPlan(0, [res.FaultSpec("serving.dispatch", "error", at=[0])])
        with res.fault_plan(plan):
            _outcome(lambda: res.maybe_fault("serving.dispatch"))
        text = export.render_prometheus({"resilience": res.summary()})
        return sorted(line for line in text.splitlines() if line.startswith("metrics_tpu_resilience"))

    assert scenario(jres, jexport) == scenario(tres, texport)


def test_seams_cost_no_tensor_work_when_no_plan_is_installed():
    # an uninstalled plan: the seam returns before touching anything
    assert tres.current_fault_plan() is None
    x = torch.zeros(3)
    for seam in tres.SEAMS:
        assert tres.maybe_fault(seam, process=0) is None
    assert torch.equal(x, torch.zeros(3))
