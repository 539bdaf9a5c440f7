"""The port's mergeable snapshots and fleet diagnostics against the JAX
package's.

* ``MERGE_RULES``/``leaf_reduction``, ``merge_snapshots``,
  ``snapshot_pytree`` and ``apply_pytree`` give the JAX package's results
  for the same snapshots exactly (the snapshots are the JAX package's own,
  and the port's, after the same activity).
* ``aggregate_snapshots`` over given snapshots, over a process's own (one
  process: the identity transport) and over a transport handing back two
  copies; ``render_prometheus(aggregated=True)`` renders the JAX package's
  text for the same fleet view (HELP lines aside: those that name XLA say
  what the port measures instead).
* ``straggler_report``/``degraded_processes`` of the same fleet dicts are
  equal exactly, published or not; a published report joins the snapshot,
  the Prometheus family and the ``straggler`` events, and the async
  engines count the same degraded rounds and stale serves.

The two-process cases (the clock handshake, ``gather_fleet``,
``aggregate_snapshots`` and the straggler verdict over gloo, the async
engine's degraded rounds) are in ``tests/test_torch_sync_gloo.py``.
"""
import copy
import json
import re
import warnings

import jax
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.observability as jobs
import metrics_tpu_torch as T
import metrics_tpu_torch.observability as tobs
from metrics_tpu.observability import aggregate as jagg
from metrics_tpu_torch.observability import aggregate as tagg

CPU = {"device": "cpu"}
NC = 4


@pytest.fixture(autouse=True)
def clean():
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
        obs.set_profiling(0)
    yield
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
        obs.set_profiling(0)


def _arr(pkg, x):
    return jax.numpy.asarray(x) if pkg is J else torch.from_numpy(np.asarray(x))


def _activity(pkg, dev, obs, seed):
    """Some of every plane's activity; returns the process's snapshot."""
    obs.reset()
    obs.set_profiling(2)
    obs.SLO_REGISTRY.declare(name="dispatch", series="dispatch_seconds", threshold=1e-3, fast_window_s=1.0,
                             slow_window_s=2.0)
    rng = np.random.RandomState(seed)
    m = pkg.Precision(average="macro", num_classes=NC, **dev).jit_forward()
    km = pkg.KeyedMetric(pkg.MeanSquaredError(**dev), 8, **dev)
    for _ in range(3 + seed):
        probs = rng.rand(8, NC).astype(np.float32)
        target = rng.randint(0, NC, 8)
        m(_arr(pkg, probs), _arr(pkg, target))
        km.update(_arr(pkg, target), _arr(pkg, probs[:, 0]), _arr(pkg, probs[:, 1]))
    obs.WATCHDOG.tick()
    obs.LEDGER.track(km)
    snap = obs.snapshot()
    obs.LEDGER.untrack(km)
    obs.set_profiling(0)
    return json.loads(json.dumps(snap))


@pytest.fixture(scope="module")
def snapshots():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsnaps = [_activity(J, {}, jobs, s) for s in range(3)]
        tsnaps = [_activity(T, CPU, tobs, s) for s in range(3)]
    for obs in (jobs, tobs):
        obs.reset()
    return jsnaps, tsnaps


def test_merge_rules_equal_the_jax_package():
    assert tagg.MERGE_RULES == jagg.MERGE_RULES
    for path in [("metrics", "A#0", "counters", "update_calls"), ("health", "policy"), ("memory", "high_water_bytes"),
                 ("slo", "slos", "x", "fast", "burn_rate"), ("profiling", "sample_every"), ("tracing", "straggler"),
                 ("unknown", "leaf")]:
        assert tagg.leaf_reduction(path) == jagg.leaf_reduction(path)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_merge_snapshots_equals_the_jax_package(snapshots, side):
    snaps = snapshots[0] if side == "jax" else snapshots[1]
    merged = tagg.merge_snapshots(copy.deepcopy(snaps))
    assert merged == jagg.merge_snapshots(copy.deepcopy(snaps))
    # empty snapshots are identities
    assert tagg.merge_snapshots([{}, *copy.deepcopy(snaps), {}]) == merged
    assert tagg.merge_snapshots([]) == {}


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_snapshot_pytree_and_apply_pytree_equal_the_jax_package(snapshots, side):
    snap = (snapshots[0] if side == "jax" else snapshots[1])[1]
    tstate, tred = tagg.snapshot_pytree(copy.deepcopy(snap))
    jstate, jred = jagg.snapshot_pytree(copy.deepcopy(snap))
    assert tred == jred and set(tstate) == set(jstate)
    for key in tstate:
        np.testing.assert_array_equal(tstate[key], jstate[key])
        assert tstate[key].dtype == jstate[key].dtype
    doubled = {k: v * 2 if tred[k] == "sum" else v for k, v in tstate.items()}
    assert tagg.apply_pytree(snap, doubled) == jagg.apply_pytree(snap, doubled)


def test_the_port_snapshot_has_the_jax_sections_and_rules(snapshots):
    jsnaps, tsnaps = snapshots
    assert set(tsnaps[0]) == set(jsnaps[0])
    for section in ("retrace", "health", "slo", "profiling", "memory"):
        assert tsnaps[0][section], section
        assert set(tsnaps[0][section]) == set(jsnaps[0][section]), section
    assert tsnaps[0]["profiling"] == jsnaps[0]["profiling"]
    assert tsnaps[0]["memory"]["tracked_bytes"] > 0


def test_aggregate_snapshots_equals_the_jax_package(snapshots):
    for snaps in snapshots:
        got = tagg.aggregate_snapshots(copy.deepcopy(snaps))
        assert got == jagg.aggregate_snapshots(copy.deepcopy(snaps))
        assert got["process_count"] == 3 and set(got["per_process"]) == {"0", "1", "2"}


def test_aggregate_snapshots_of_this_process():
    m = T.Accuracy(**CPU)
    m(torch.rand(4, NC), torch.randint(0, NC, (4,)))
    one = tobs.aggregate_snapshots()
    assert one["process_count"] == 1
    assert one["merged"]["metrics"][m.telemetry_key]["counters"]["forward_fused_calls"] == 1
    assert "aggregate|all|snapshot|0" in [s.span_id for s in tobs.TRACER.records()]

    def two_copies(trees):
        return [[leaf, leaf.clone()] for leaf in trees]

    two = tobs.aggregate_snapshots(transport=two_copies)
    assert two["process_count"] == 2
    assert two["merged"]["metrics"][m.telemetry_key]["counters"]["forward_fused_calls"] == 2


def _no_help(text):
    return [line for line in text.splitlines() if not line.startswith("# HELP")]


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_aggregated_prometheus_text_equals_the_jax_package(snapshots, side):
    snaps = snapshots[0] if side == "jax" else snapshots[1]
    view = jagg.aggregate_snapshots(copy.deepcopy(snaps))
    ttext = tobs.render_prometheus(copy.deepcopy(view), aggregated=True)
    jtext = jobs.render_prometheus(copy.deepcopy(view), aggregated=True)
    assert _no_help(ttext) == _no_help(jtext)
    assert "metrics_tpu_processes 3" in ttext and 'process="2"' in ttext


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_prometheus_text_of_the_new_sections_equals_the_jax_package(snapshots, side):
    snap = (snapshots[0] if side == "jax" else snapshots[1])[0]
    part = {k: snap[k] for k in ("retrace", "health", "slo", "profiling", "memory", "histograms", "metrics")}
    ttext, jtext = tobs.render_prometheus(copy.deepcopy(part)), jobs.render_prometheus(copy.deepcopy(part))
    assert _no_help(ttext) == _no_help(jtext)
    for family in ("retrace_compiles_total", "state_bytes", "slo_burn_rate", "profiling_samples_total",
                   "memory_tracked_bytes", "dispatch_device_seconds_bucket"):
        assert f"metrics_tpu_{family}" in ttext, family


# -- straggler diagnostics -----------------------------------------------------------


def _fleet(lags, n=4, world=3):
    """A fleet dict whose process p enters collective i ``lags[p][i]`` late."""
    processes = []
    for p in range(world):
        spans = []
        for i in range(n):
            enter = 10.0 * i + lags[p][i]
            spans.append({"span_id": f"gather|all|transport|{i}", "kind": "gather", "group": "all",
                          "bucket": "transport", "seq": i, "process": p, "enter_s": enter,
                          "exit_s": 10.0 * i + max(lag[i] for lag in lags) + 0.001, "step": None, "payload": {}})
        spans.append({"span_id": f"gather|all|descriptor|{0}", "kind": "gather", "group": "all",
                      "bucket": "descriptor", "seq": 0, "process": p, "enter_s": 0.0, "exit_s": 1.0, "step": None,
                      "payload": {}})
        processes.append({"process": p, "epoch_unix": 0.0, "events": [], "spans": spans})
    return {"processes": processes, "clock": {"offsets": [0.0] * world, "uncertainty_s": 0.0001}}


FLEETS = {
    "balanced": [[0.0] * 4, [0.0] * 4, [0.0] * 4],
    "rank1_slow": [[0.0] * 4, [0.05, 0.06, 0.04, 0.05], [0.01] * 4],
    "rank2_once": [[0.0] * 4, [0.0] * 4, [0.0, 0.2, 0.0, 0.0]],
}


@pytest.mark.parametrize("name", list(FLEETS))
@pytest.mark.parametrize("kwargs", [{}, {"flag_fraction": 0.25}, {"min_lag_s": 0.1}, {"min_spans": 5}])
def test_straggler_report_equals_the_jax_package(name, kwargs):
    fleet = _fleet(FLEETS[name])
    got = tobs.straggler_report(copy.deepcopy(fleet), **kwargs)
    assert got == jobs.straggler_report(copy.deepcopy(fleet), **kwargs)
    assert tobs.degraded_processes(got) == jobs.degraded_processes(got)
    assert tobs.straggler_report(fleet["processes"], **kwargs)["processes"] == got["processes"]


def test_a_published_report_flags_the_slow_process_everywhere():
    fleet = _fleet(FLEETS["rank1_slow"])
    assert tobs.degraded_processes() == []
    for obs in (jobs, tobs):
        obs.straggler_report(copy.deepcopy(fleet), publish=True)
    assert tobs.degraded_processes() == jobs.degraded_processes() == [1]
    tsnap, jsnap = tobs.snapshot(), jobs.snapshot()
    assert tsnap["tracing"]["straggler"] == jsnap["tracing"]["straggler"]
    events = [(e.kind, e.payload) for e in tobs.EVENTS.events() if e.kind == "straggler"]
    assert events == [(e.kind, e.payload) for e in jobs.EVENTS.events() if e.kind == "straggler"]
    part = {"tracing": tsnap["tracing"]}
    assert _no_help(tobs.render_prometheus(part)) == _no_help(jobs.render_prometheus(part))
    assert 'metrics_tpu_straggler_flagged{peer="1"} 1' in tobs.render_prometheus(part)
    tobs.reset()
    assert tobs.degraded_processes() == [] and tobs.snapshot()["tracing"]["straggler"] is None


def test_one_process_needs_no_handshake():
    assert tobs.estimate_clock_offsets() == jobs.estimate_clock_offsets()
    fleet = tobs.tracing.gather_fleet()
    assert [p["process"] for p in fleet["processes"]] == [0]
    assert re.fullmatch(r"\{.*\}", json.dumps(fleet))


def test_the_engines_count_degraded_rounds_and_serve_stale_as_the_jax_package():
    fleet = _fleet(FLEETS["rank1_slow"])
    out = []
    for pkg, dev, obs in ((J, {}, jobs), (T, CPU, tobs)):
        m = pkg.MeanSquaredError(**dev)
        m.update(_arr(pkg, np.array([1.0, 2.0], np.float32)), _arr(pkg, np.array([1.0, 1.0], np.float32)))
        first = float(m.compute_async(on_degraded="stale").result(timeout=30))
        obs.straggler_report(copy.deepcopy(fleet), publish=True)
        stale = m.compute_async(on_degraded="stale")
        value = float(stale.result(timeout=30))
        retried = float(m.compute_async(on_degraded="retry").result(timeout=30))
        engine = obs.snapshot()["async_sync"]
        out.append(({k: engine[k] for k in ("submitted", "completed", "stale_serves", "degraded_rounds", "failed")},
                    stale.stale, first, value, retried))
        obs.TRACER.set_fleet_report(None)
    assert out[1] == out[0]
    assert out[1][0]["degraded_rounds"] == 2 and out[1][0]["stale_serves"] == 1 and out[1][1] is True
