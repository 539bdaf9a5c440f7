"""The port's health plane against the JAX package's.

The same seeded numpy call sequences go through the JAX objects and the
port's (``device="cpu"``), each package under the same health policy, and
the health ledgers (``snapshot()["health"]``) and the ``health`` events
(source, and the states flagged nan/inf/zero_weight) are compared object by
object: every flag is a boolean, so the comparison is exact, whatever the
states' dtypes (the JAX package runs with x64 here, the port keeps float32
sums and int64 counts). The JAX package's compiled guard reports through
``jax.debug.callback`` (awaited with ``jax.effects_barrier()``), the port's
through the flags its compiled dispatch queues, noted on the CPU as the
dispatch returns; events are compared in order on the eager paths and as
multisets where a compiled program's callbacks may interleave.

* ``check_health`` reports of a metric, a collection, a composition and a
  keyed bundle; NaN/Inf counts and the zero total-weight flag.
* A NaN or Inf injected at step k into a float state of a metric, a
  collection and a keyed collection, eager and compiled, under ``"record"``;
  the warn-once of ``"warn"``; ``MetricHealthError`` under ``"raise"`` on the
  eager paths and the warning of a compiled one.
* Policy ``"off"`` computes no flag anywhere.
* ``quarantine="auto"`` sheds NaN rows under every policy but ``"off"``.
* The compiled guard's queue: a copy still in flight is not noted, and no
  flag is read inside the program.
"""
import json
import warnings

import jax
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.observability as jobs
import metrics_tpu_torch as T
import metrics_tpu_torch.observability as tobs
from metrics_tpu_torch.observability import health as thealth
from tests.test_torch_serving import _both, _recording_queue

CPU = {"device": "cpu"}
NC = 3


@pytest.fixture(autouse=True)
def clean():
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
        obs.set_health_policy("off")
    yield
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
        obs.set_health_policy("off")


def _policy(policy):
    for obs in (jobs, tobs):
        obs.set_health_policy(policy)


def _arr(pkg, x):
    return jax.numpy.asarray(x) if pkg is J else torch.from_numpy(np.asarray(x))


def _names(objs):
    return {o.telemetry_key: f"m{i}" for i, o in enumerate(objs)}


def _ledger(obs, objs):
    """The health section with each compared object's key renamed to its
    position (an object outside ``objs`` keeps its key)."""
    names = _names(objs)
    summary = obs.HEALTH.summary()
    return {
        "policy": summary["policy"],
        "unhealthy_total": summary["unhealthy_total"],
        "metrics": {names.get(k, k): v for k, v in summary["metrics"].items()},
    }


def _events(obs, objs):
    names = _names(objs)
    return [
        (names.get(e.metric, e.metric), e.payload["source"], e.payload["nan"], e.payload["inf"],
         e.payload["zero_weight"])
        for e in obs.EVENTS.events() if e.kind == "health"
    ]


def _counters(obs, objs):
    snap = obs.snapshot()["metrics"]
    return [snap.get(o.telemetry_key, {}).get("counters", {}).get("health_events", 0) for o in objs]


def _regression_batches(k=None, bad=np.nan, n=6, steps=4, seed=0):
    """``steps`` (preds, target) float32 batches; ``bad`` at row 1 of step ``k``."""
    rng = np.random.RandomState(seed)
    out = []
    for step in range(steps):
        preds, target = rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32)
        if step == k:
            preds[1] = bad
        out.append((preds, target))
    return out


def _compare(run, ordered=True):
    """Run ``run(pkg, dev)`` on both packages (it returns the objects to
    compare); the ledgers, events and counters must be equal."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_objs = run(J, {})
        jax.effects_barrier()
        port_objs = run(T, CPU)
    assert _ledger(tobs, port_objs) == _ledger(jobs, jax_objs)
    got, want = _events(tobs, port_objs), _events(jobs, jax_objs)
    assert (got if ordered else sorted(got)) == (want if ordered else sorted(want))
    assert _counters(tobs, port_objs) == _counters(jobs, jax_objs)
    return jax_objs, port_objs


# -- check_health --------------------------------------------------------------------


def _mask_key(report):
    return {k: (_mask_key(v) if isinstance(v, dict) else v) for k, v in report.items() if k != "metric"}


def test_check_health_reports_equal_the_jax_package():
    rng = np.random.RandomState(0)
    probs = rng.rand(8, NC).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    target = rng.randint(0, NC, 8)
    reports = {}
    for pkg, dev in ((J, {}), (T, CPU)):
        acc = pkg.Accuracy(**dev)
        acc(_arr(pkg, probs), _arr(pkg, target))
        avg = pkg.AverageMeter(**dev)
        fresh = avg.check_health()
        avg.update(_arr(pkg, np.array([1.0, 2.0])), _arr(pkg, np.array([0.0, 0.0])))
        zero = avg.check_health()
        avg.value = _arr(pkg, np.array([np.nan, np.inf, 1.0, np.nan]))
        bad = avg.check_health()
        coll = pkg.MetricCollection([pkg.Accuracy(**dev), pkg.Precision(average="macro", num_classes=NC, **dev)])
        coll(_arr(pkg, probs), _arr(pkg, target))
        comp = pkg.Precision(average="macro", num_classes=NC, **dev) + pkg.Recall(average="macro", num_classes=NC, **dev)
        comp.update(_arr(pkg, probs), _arr(pkg, target))
        state = acc.apply_update(acc.init_state(), _arr(pkg, probs), _arr(pkg, target))
        reports[pkg] = {
            "acc": acc.check_health(), "explicit": acc.check_health(state), "fresh": fresh, "zero": zero,
            "bad": bad, "coll": coll.check_health(), "comp": comp.check_health(),
        }
        assert reports[pkg]["acc"]["metric"] == acc.telemetry_key
    got, want = reports[T], reports[J]
    for name in want:
        assert _mask_key(got[name]) == _mask_key(want[name]), name
    assert got["bad"]["states"]["value"] == {"nan": 2, "inf": 1}
    assert got["zero"]["states"]["weight"]["zero_weight"] is True and got["fresh"]["healthy"] is True
    assert json.loads(json.dumps(got["coll"])) == got["coll"]
    # an explicit unhealthy check records at policy "off" too
    assert tobs.HEALTH.summary()["unhealthy_total"] == jobs.HEALTH.summary()["unhealthy_total"] == 2


def test_check_health_of_a_keyed_bundle():
    batches = _regression_batches(k=1)
    ids = np.array([0, 1, 2, 0, 1, 2])
    out = []
    for pkg, dev in ((J, {}), (T, CPU)):
        km = pkg.KeyedMetric(pkg.MeanSquaredError(**dev), 3, **dev)
        for preds, target in batches:
            km.update(_arr(pkg, ids), _arr(pkg, preds), _arr(pkg, target))
        out.append(_mask_key(km.check_health()))
    assert out[1] == out[0]
    assert out[1]["states"]["sum_squared_error"] == {"nan": 1, "inf": 0}


# -- the guard: eager ----------------------------------------------------------------


def _seq_metric(k, bad, forward_at=None):
    def run(pkg, dev):
        m = pkg.MeanSquaredError(**dev)
        for step, (preds, target) in enumerate(_regression_batches(k, bad)):
            call = m if step == forward_at else m.update
            call(_arr(pkg, preds), _arr(pkg, target))
        return [m]

    return run


def _seq_collection(k, bad):
    def run(pkg, dev):
        coll = pkg.MetricCollection([pkg.MeanSquaredError(**dev), pkg.MeanAbsoluteError(**dev)])
        for step, (preds, target) in enumerate(_regression_batches(k, bad)):
            (coll if step % 2 else coll.update)(_arr(pkg, preds), _arr(pkg, target))
        return [m for _, m in coll.items(keep_base=True)]

    return run


def _keyed_collection(pkg, dev):
    members = [pkg.MeanSquaredError(**dev), pkg.MeanAbsoluteError(**dev), pkg.PearsonCorrcoef(streaming=True, **dev)]
    return pkg.MultiTenantCollection(members, 4, **dev)


def _keyed_objects(mtc):
    """The keyed bundles, then their children: the per-row guard's keys."""
    bundles = list(mtc._keyed.values())
    return [km._child for km in bundles] + bundles


def _seq_keyed(k, bad):
    def run(pkg, dev):
        mtc = _keyed_collection(pkg, dev)
        ids = np.array([0, 1, 2, 3, 0, 1])
        for preds, target in _regression_batches(k, bad):
            mtc.update(_arr(pkg, ids), _arr(pkg, preds), _arr(pkg, target))
        return _keyed_objects(mtc)

    return run


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("k", [0, 2])
@pytest.mark.parametrize("seq", ["metric", "forward", "collection", "keyed"])
def test_a_bad_value_at_step_k_is_flagged_as_in_the_jax_package(seq, k, bad):
    """The keyed collection's per-row guard runs inside the JAX package's
    compiled keyed update, so its events are compared as a multiset."""
    _policy("record")
    run = {
        "metric": _seq_metric(k, bad),
        "forward": _seq_metric(k, bad, forward_at=k),
        "collection": _seq_collection(k, bad),
        "keyed": _seq_keyed(k, bad),
    }[seq]
    _, port_objs = _compare(run, ordered=seq != "keyed")
    ledger = _ledger(tobs, port_objs)
    assert ledger["unhealthy_total"] > 0
    kind = "nan" if np.isnan(bad) else "inf"
    assert any(e[2 if kind == "nan" else 3] for e in _events(tobs, port_objs))


def test_the_keyed_rows_are_checked_one_by_one():
    _policy("record")
    _, port_objs = _compare(_seq_keyed(2, np.nan), ordered=False)
    ledger = _ledger(tobs, port_objs)
    # four updates of six rows: one check per row and member bundle
    assert ledger["metrics"]["m0"] == {"checks": 24, "unhealthy": 1, "nan": 1, "inf": 0, "zero_weight": 0}
    assert ("m0", "apply_update", ["sum_squared_error"], [], []) in _events(tobs, port_objs)


def test_policy_warn_warns_once_per_metric():
    _policy("warn")
    for pkg, dev in ((J, {}), (T, CPU)):
        avg = pkg.AverageMeter(**dev)
        with pytest.warns(UserWarning, match="numerically unhealthy"):
            avg.update(_arr(pkg, np.array([np.nan])))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            avg.update(_arr(pkg, np.array([np.nan])))
        assert pkg.observability.HEALTH.summary()["metrics"][avg.telemetry_key]["unhealthy"] == 2


@pytest.mark.parametrize("call", ["update", "forward", "collection"])
def test_policy_raise_raises_from_the_eager_call(call):
    _policy("raise")
    for pkg, dev in ((J, {}), (T, CPU)):
        errors = pkg.observability.MetricHealthError
        if call == "collection":
            target = pkg.MetricCollection([pkg.MeanSquaredError(**dev)])
        else:
            target = pkg.MeanSquaredError(**dev)
        fn = target.update if call == "update" else target
        fn(_arr(pkg, np.array([1.0, 2.0], np.float32)), _arr(pkg, np.array([1.0, 1.0], np.float32)))
        with pytest.raises(errors, match="nan in state"):
            fn(_arr(pkg, np.array([np.nan, 2.0], np.float32)), _arr(pkg, np.array([1.0, 1.0], np.float32)))


def test_the_eager_keyed_update_raises_before_its_state_changes():
    """A divergence, stated: the port's keyed update is eager, so under
    ``"raise"`` its row guard raises and the rows are not scattered; the JAX
    package's keyed update is compiled, so it warns once and scatters."""
    _policy("raise")
    ids = np.array([0, 1, 2, 3, 0, 1])
    clean, poisoned = _regression_batches(k=1, steps=2)
    mtc = _keyed_collection(T, CPU)
    mtc.update(_arr(T, ids), _arr(T, clean[0]), _arr(T, clean[1]))
    before = {o: {k: v.clone() for k, v in km._get_states().items()} for o, km in mtc._keyed.items()}
    with pytest.raises(tobs.MetricHealthError):
        mtc.update(_arr(T, ids), _arr(T, poisoned[0]), _arr(T, poisoned[1]))
    for owner, km in mtc._keyed.items():
        for name, value in km._get_states().items():
            assert torch.equal(value, before[owner][name])
    jmtc = _keyed_collection(J, {})
    jmtc.update(_arr(J, ids), _arr(J, clean[0]), _arr(J, clean[1]))
    with pytest.warns(UserWarning, match="numerically unhealthy"):
        jmtc.update(_arr(J, ids), _arr(J, poisoned[0]), _arr(J, poisoned[1]))
        jax.effects_barrier()


def test_policy_off_computes_no_flag(monkeypatch):
    calls = []
    for name in ("_flag_exprs", "_row_flag_exprs"):
        real = getattr(thealth, name)
        monkeypatch.setattr(thealth, name, lambda *a, _real=real, **k: calls.append(1) or _real(*a, **k))
    for seq in (_seq_metric(1, np.nan), _seq_collection(1, np.nan), _seq_keyed(1, np.nan)):
        seq(T, CPU)
    m = T.MeanSquaredError(**CPU).jit_forward()
    m(torch.tensor([np.nan, 1.0]), torch.tensor([1.0, 1.0]))
    assert calls == []
    assert tobs.HEALTH.summary() == jobs.HEALTH.summary() == {"policy": "off", "unhealthy_total": 0, "metrics": {}}


def test_the_guard_leaves_values_unchanged():
    batches = _regression_batches(k=None)
    values = []
    for policy in ("off", "record"):
        _policy(policy)
        m = T.MeanSquaredError(**CPU)
        for preds, target in batches:
            m.update(_arr(T, preds), _arr(T, target))
        values.append(m.compute())
    assert torch.equal(values[0], values[1])


# -- the guard: compiled --------------------------------------------------------------


def test_nan_under_jit_forward_is_flagged_by_the_dispatch():
    _policy("record")

    def run(pkg, dev):
        avg = pkg.AverageMeter(**dev).jit_forward()
        avg(_arr(pkg, np.array([1.0, 2.0])))
        avg.value = _arr(pkg, np.array(np.nan))  # poison the accumulator
        avg(_arr(pkg, np.array([1.0, 2.0])))
        return [avg]

    _, (avg,) = _compare(run, ordered=False)
    assert tobs.HEALTH.in_flight() == 0  # on the CPU the flags are final at once
    assert any("value" in e[2] for e in _events(tobs, [avg]))


@pytest.mark.parametrize("seq", ["collection", "keyed"])
def test_a_compiled_collection_flags_a_nan_at_its_step(seq):
    _policy("record")
    batches = _regression_batches(k=2)

    def run(pkg, dev):
        if seq == "collection":
            coll = pkg.MetricCollection([pkg.MeanSquaredError(**dev), pkg.MeanAbsoluteError(**dev)]).jit_forward()
            for preds, target in batches:
                coll(_arr(pkg, preds), _arr(pkg, target))
            return [m for _, m in coll.items(keep_base=True)]
        mtc = _keyed_collection(pkg, dev)
        ids = _arr(pkg, np.array([0, 1, 2, 3, 0, 1]))
        mtc.warmup(ids, _arr(pkg, batches[0][0]), _arr(pkg, batches[0][1]))
        for preds, target in batches:
            mtc.update(ids, _arr(pkg, preds), _arr(pkg, target))
        return _keyed_objects(mtc)

    _compare(run, ordered=False)


def test_update_many_flags_every_step_after_the_nan():
    """The JAX package's scan traces the update once and its callback fires
    per step; the port unrolls K updates, each with its guard."""
    _policy("record")
    values = np.array([1.0, 2.0, np.nan, 3.0, 4.0])

    def run(pkg, dev):
        m = pkg.AverageMeter(**dev)
        m.update_many(_arr(pkg, values.reshape(5, 1)))
        return [m]

    _, (m,) = _compare(run, ordered=False)
    assert _ledger(tobs, [m])["metrics"]["m0"]["checks"] == 5
    assert _ledger(tobs, [m])["metrics"]["m0"]["unhealthy"] == 3  # NaN sticks in the sum


def test_keyed_update_many_guards_the_rows_and_the_stacked_state():
    _policy("record")
    preds = np.array([[0.1, 0.2, 0.3], [0.4, np.nan, 0.6]], np.float32)
    target = np.full((2, 3), 0.5, np.float32)
    ids = np.array([[0, 1, 2], [2, 1, 0]])

    def run(pkg, dev):
        km = pkg.KeyedMetric(pkg.MeanSquaredError(**dev), 3, **dev)
        km.update_many(_arr(pkg, ids), _arr(pkg, preds), _arr(pkg, target))
        return [km, km._child]

    _, (km, child) = _compare(run, ordered=False)
    ledger = _ledger(tobs, [km, child])["metrics"]
    assert ledger["m0"]["checks"] == 2 and ledger["m0"]["nan"] == 1  # the stacked state, once a step
    assert ledger["m1"]["checks"] == 6 and ledger["m1"]["nan"] == 1  # the rows


def test_policy_raise_warns_once_under_a_compiled_step():
    _policy("raise")
    for pkg, dev in ((J, {}), (T, CPU)):
        avg = pkg.AverageMeter(**dev).jit_forward()
        avg.value = _arr(pkg, np.array(np.nan))
        with pytest.warns(UserWarning, match="numerically unhealthy"):
            avg(_arr(pkg, np.array([1.0])))
            if pkg is J:
                jax.effects_barrier()


def test_arming_the_policy_captures_afresh_and_disarming_replays_the_old_program():
    m = T.MeanSquaredError(**CPU).jit_forward()
    x = torch.tensor([1.0, 2.0])
    m(x, x)
    fn = m._jit_forward_fn
    assert fn._cache_size() == 1
    _policy("record")
    m(x, x)
    assert fn._cache_size() == 2 and fn.last_compiled
    _policy("off")
    m(x, x)
    assert fn._cache_size() == 2 and not fn.last_compiled


def test_a_flag_copy_in_flight_is_noted_once_it_completes():
    class _Event:
        done = False

        def query(self):
            return self.done

    _policy("record")
    mon = thealth.HealthMonitor(policy="record")
    slots = [("M#0", ("v",), "apply_update", (1, 3), False), ("R#0", ("a", "b"), "apply_update", (2, 2, 3), True)]
    first = torch.tensor([True, False, False] + [False] * 6 + [False, True, False, False, False, False])
    mon.defer(slots, first)
    event = _Event()
    mon._pending[0].event = event
    mon.defer(slots, torch.zeros(15, dtype=torch.bool))
    assert mon.drain() == 0 and mon.in_flight() == 2  # the oldest blocks the queue
    event.done = True
    assert mon.drain() == 2 and mon.in_flight() == 0
    ledger = mon.summary()["metrics"]
    assert ledger["M#0"] == {"checks": 2, "unhealthy": 1, "nan": 1, "inf": 0, "zero_weight": 0}
    assert ledger["R#0"] == {"checks": 4, "unhealthy": 1, "nan": 0, "inf": 1, "zero_weight": 0}  # row 1, state "a"


def test_no_flag_is_read_inside_the_compiled_program(monkeypatch):
    _policy("record")
    real = torch.Tensor.cpu

    def guarded(self, *args, **kwargs):
        from metrics_tpu_torch.utilities.data import _is_traced

        assert not _is_traced(), "a flag was read inside the compiled program"
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", guarded)
    coll = T.MetricCollection([T.MeanSquaredError(**CPU), T.MeanAbsoluteError(**CPU)]).jit_forward()
    x = torch.tensor([np.nan, 1.0])
    coll(x, x)
    coll(x, x)
    assert tobs.HEALTH.summary()["unhealthy_total"] > 0


# -- quarantine="auto" ---------------------------------------------------------------


@pytest.mark.parametrize("staging", [False, True])
@pytest.mark.parametrize("policy", ["off", "record", "warn", "raise"])
def test_quarantine_auto_follows_the_health_policy(policy, staging):
    _policy(policy)

    def scenario(side):
        rec, q = _recording_queue(side, quarantine="auto", staging=staging)
        q.submit_many(np.arange(4), np.array([0.1, np.nan, 0.3, np.inf], np.float32), np.array([1, 0, 1, 1], np.int32))
        q.flush()
        return rec, q, None

    _, t = _both(scenario)
    if policy == "off":
        assert t["stats"]["shed"] == 0 and len(t["calls"][0][0]) == 4
    else:
        assert t["stats"]["shed_by_reason"] == {"poisoned": 2}
        np.testing.assert_array_equal(t["calls"][0][0], [0, 2])
