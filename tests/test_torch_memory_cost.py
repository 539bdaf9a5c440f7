"""The port's memory ledger, cost reports and retrace ledger against the JAX
package's.

* ``state_memory_report`` of metrics (fixed and list states), a collection,
  a composition and a keyed bundle: per state, bytes equal where the two
  packages' dtypes agree, element counts (bytes over the element size)
  equal where they do not (the JAX package runs with x64 here: float64 and
  int64 where the port keeps float32 sums and int64 counts); ``warmup``'s
  ``"state_memory"`` equals ``state_memory_report()`` in the port and
  counts the JAX package's elements.
* The ledger (``track``/``note``/``untrack``, the conservation check, the
  high-water, watermarks with hysteresis, ``summary``, ``reset`` and
  ``disable``) gives the JAX package's reports for the same sequence of
  operations on objects of equal element counts; the ``add_metrics`` and
  ``MultiTenantCollection.build`` seams re-note it; the snapshot's ``memory``
  section and ``metrics_tpu_memory_*``/``state_bytes`` series render the
  JAX package's text.
* ``cost_report``/``warmup`` carry the JAX package's keys; every XLA cost
  entry is ``{"available": False}`` in the port (no figure is made up).
* The retrace ledger: compiles per signature, the signatures, the warning
  past the threshold, and ``update_traces``/``compute_traces`` equal the JAX
  package's for the same ``jit_forward``/``update_many`` calls.
"""
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
from metrics_tpu.observability import memory as jmemory
from metrics_tpu_torch.observability import cost as tcost
from metrics_tpu_torch.observability import memory as tmemory

CPU = {"device": "cpu"}
NC = 4


@pytest.fixture(autouse=True)
def clean():
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
        obs.set_retrace_threshold(3)
    yield
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
        obs.set_retrace_threshold(3)


def _arr(pkg, x):
    return jax.numpy.asarray(x) if pkg is J else torch.from_numpy(np.asarray(x))


def _batch(seed=0, n=8):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, NC).astype(np.float32)
    return probs / probs.sum(-1, keepdims=True), rng.randint(0, NC, n)


def _itemsize(value):
    if isinstance(value, (list, tuple)):
        return _itemsize(value[0]) if value else 1
    return value.element_size() if isinstance(value, torch.Tensor) else value.dtype.itemsize


def _elements(report, metric):
    """``report``'s per-state bytes as element counts of ``metric``'s states."""
    return {
        name: {**entry, "bytes": entry["bytes"] // _itemsize(getattr(metric, name))}
        for name, entry in report["per_state"].items()
    }


def _metrics(pkg, dev):
    probs, target = _batch()
    out = {
        "accuracy": pkg.Accuracy(**dev),
        "auroc": pkg.AUROC(num_classes=NC, **dev),
        "mse": pkg.MeanSquaredError(**dev),
        "confmat": pkg.ConfusionMatrix(NC, **dev),
    }
    out["accuracy"](_arr(pkg, probs), _arr(pkg, target))
    for _ in range(2):
        out["auroc"].update(_arr(pkg, probs), _arr(pkg, target))
    out["mse"].update(_arr(pkg, probs[:, 0]), _arr(pkg, probs[:, 1]))
    out["confmat"].update(_arr(pkg, probs), _arr(pkg, target))
    return out


@pytest.mark.parametrize("name", ["accuracy", "auroc", "mse", "confmat"])
def test_state_memory_report_counts_the_jax_package_elements(name):
    jm, tm = _metrics(J, {})[name], _metrics(T, CPU)[name]
    jrep, trep = jm.state_memory_report(), tm.state_memory_report()
    assert _elements(trep, tm) == _elements(jrep, jm)
    for state, entry in trep["per_state"].items():
        if _itemsize(getattr(tm, state)) == _itemsize(getattr(jm, state)):
            assert entry == jrep["per_state"][state], state  # same dtype: same bytes
    assert trep["total_bytes"] == sum(e["bytes"] for e in trep["per_state"].values())
    assert trep["total_bytes"] == tcost.pytree_nbytes(tm._get_states())


def test_collection_composition_and_keyed_reports():
    probs, target = _batch()
    reports = []
    for pkg, dev in ((J, {}), (T, CPU)):
        coll = pkg.MetricCollection([pkg.Accuracy(**dev), pkg.Precision(average="macro", num_classes=NC, **dev)])
        coll(_arr(pkg, probs), _arr(pkg, target))
        comp = pkg.Precision(average="macro", num_classes=NC, **dev) * 2
        km = pkg.KeyedMetric(pkg.MeanSquaredError(**dev), 5, **dev)
        km.update(_arr(pkg, np.array([0, 4])), _arr(pkg, probs[:2, 0]), _arr(pkg, probs[:2, 1]))
        reports.append((coll, coll.state_memory_report(), comp, comp.state_memory_report(), km,
                        km.state_memory_report()))
    (jc, jcr, jp, jpr, jk, jkr), (tc, tcr, tp, tpr, tk, tkr) = reports
    assert set(tcr["per_metric"]) == set(jcr["per_metric"])
    for name, rep in tcr["per_metric"].items():
        assert _elements(rep, tc[name]) == _elements(jcr["per_metric"][name], jc[name])
    assert _elements(tpr["per_state"]["a"], tp.metric_a) == _elements(jpr["per_state"]["a"], jp.metric_a)
    assert set(tpr["per_state"]) == set(jpr["per_state"]) == {"a"}
    assert _elements(tkr, tk) == _elements(jkr, jk)
    assert tkr["total_bytes"] == sum(v.numel() * v.element_size() for v in tk._get_states().values())


def test_warmup_reports_carry_the_state_memory_and_the_jax_keys():
    probs, target = _batch()
    for pkg, dev in ((J, {}), (T, CPU)):
        m = pkg.Precision(average="macro", num_classes=NC, **dev)
        report = m.warmup(_arr(pkg, probs), _arr(pkg, target))
        km = pkg.KeyedMetric(pkg.MeanSquaredError(**dev), 5, **dev)
        keyed = km.warmup(_arr(pkg, np.array([0, 4])), _arr(pkg, probs[:2, 0]), _arr(pkg, probs[:2, 1]))
        mtc = pkg.MultiTenantCollection([pkg.MeanSquaredError(**dev), pkg.MeanAbsoluteError(**dev)], 5, **dev)
        mtc_report = mtc.warmup(_arr(pkg, np.array([0, 4])), _arr(pkg, probs[:2, 0]), _arr(pkg, probs[:2, 1]))
        if pkg is J:
            want = (report, keyed, mtc_report, m, km)
            continue
        assert report["state_memory"] == m.state_memory_report()
        assert keyed["state_memory"] == km.state_memory_report()
        assert mtc_report["state_memory"] == {o: k.state_memory_report() for o, k in mtc._keyed.items()}
        jreport, jkeyed, jmtc, jm, jkm = want
        assert set(jreport) <= set(report) and set(jkeyed) <= set(keyed) and set(jmtc) <= set(mtc_report)
        assert _elements(report["state_memory"], m) == _elements(jreport["state_memory"], jm)
        assert _elements(keyed["state_memory"], km) == _elements(jkeyed["state_memory"], jkm)
        assert report["forward"] == keyed["update"] == mtc_report["update"] == tcost.executable_cost()
        assert report["forward"]["available"] is False and jreport["forward"]["available"] is True


def test_cost_report_has_the_jax_keys_and_no_figure():
    probs, target = _batch()
    out = []
    for pkg, dev in ((J, {}), (T, CPU)):
        m = pkg.Precision(average="macro", num_classes=NC, **dev)
        coll = pkg.MetricCollection([pkg.Accuracy(**dev), m])
        out.append((m.cost_report(_arr(pkg, probs), _arr(pkg, target)),
                    coll.cost_report(_arr(pkg, probs), _arr(pkg, target)), m))
    (jrep, jcoll, jm), (trep, tcoll, tm) = out
    assert set(trep) == set(jrep) and set(tcoll) == set(jcoll)
    assert set(tcoll["members"]) == set(jcoll["members"])
    for entry in (trep["update"], trep["compute"], tcoll["fused_update"]):
        assert entry == {"available": False, "reason": tcost.NO_COST_ANALYSIS}
    assert _elements(trep["state_memory"], tm) == _elements(jrep["state_memory"], jm)
    assert tobs.program_cost(lambda x: x, torch.ones(2))["available"] is False


# -- the ledger ---------------------------------------------------------------------


class _Owner:
    """An owner of a given byte count (the ledger reads ``state_memory_report``)."""

    def __init__(self, key, nbytes):
        self.telemetry_key = key
        self.nbytes = nbytes

    def state_memory_report(self):
        return {"per_state": {}, "total_bytes": self.nbytes}


def _ledger_script(mod):
    """One sequence of ledger operations; returns what it observed."""
    ledger = mod.MemoryLedger()
    fired = []
    a, b = _Owner("A#0", 1000), _Owner("B#0", 3000)
    out = {"track_a": ledger.track(a), "summary0": ledger.summary()}
    handle = ledger.on_pressure(fired.append, high=3500, low=2000)
    ledger.track(b)
    b.nbytes = 6000
    ledger.note(b)  # above high again: armed only after falling below low
    b.nbytes = 500
    ledger.note(b)
    b.nbytes = 4000
    ledger.note(b)
    ledger.note(_Owner("C#0", 10))  # untracked: a probe, nothing more
    a.nbytes = 1200  # a torn seam: not re-noted
    out["report_torn"] = ledger.report()
    ledger.note(a)
    out["report"] = ledger.report()
    out["fired"] = list(fired)
    handle.cancel()
    ledger.untrack(b)
    out["after_untrack"] = ledger.summary()
    ledger.reset()
    out["after_reset"] = ledger.summary()
    ledger.on_pressure(fired.append, high=10)
    ledger.disable()
    out["after_disable"] = ledger.summary()
    out["samples"] = [n for _, n in ledger.samples()]
    return out


def test_the_ledger_reports_equal_the_jax_package():
    got, want = _ledger_script(tmemory), _ledger_script(jmemory)
    assert got == want
    assert got["fired"] == [4000, 5000]  # once per crossing, re-armed below low
    assert got["report_torn"]["conservation_ok"] is False and got["report"]["conservation_ok"] is True


def test_the_collection_seams_renote_the_ledger():
    probs, target = _batch()
    for pkg, dev in ((J, {}), (T, CPU)):
        obs = pkg.observability
        coll = pkg.MetricCollection([pkg.Accuracy(**dev)])
        coll(_arr(pkg, probs), _arr(pkg, target))
        obs.LEDGER.track(coll)
        before = obs.LEDGER.owner_bytes(coll)
        coll.add_metrics({"P": pkg.Precision(average="macro", num_classes=NC, **dev)})
        assert obs.LEDGER.owner_bytes(coll) > before
        assert obs.memory_report()["conservation_ok"]
        obs.LEDGER.untrack(coll)
    mtc = T.MultiTenantCollection([T.MeanSquaredError(**CPU), T.MeanAbsoluteError(**CPU)], 10_000, **CPU)
    tobs.LEDGER.track(mtc)
    assert tobs.LEDGER.owner_bytes(mtc) == 0  # no bundle yet
    mtc.build()
    nbytes = sum(v.numel() * v.element_size() for km in mtc._keyed.values() for v in km._get_states().values())
    assert tobs.LEDGER.owner_bytes(mtc) == nbytes == tobs.bundle_bytes(mtc)
    report = tobs.memory_report()
    assert report["owners"][mtc.telemetry_key]["device_bytes"] == nbytes and report["conservation_ok"]
    tobs.LEDGER.untrack(mtc)


def _untrack_leftovers(ledger):
    """Untrack the owners earlier tests in this process left in ``ledger``
    (kept alive by compiled functions that close over them), so that a
    whole-ledger comparison sees this test's owners alone."""
    for entry in list(ledger._entries.values()):
        owner = entry["ref"]()
        if owner is not None:
            ledger.untrack(owner)


def test_snapshot_memory_section_and_prometheus_equal_the_jax_package():
    texts = []
    for mod in (jmemory, tmemory):
        _untrack_leftovers(mod.LEDGER)
    for mod, obs in ((jmemory, jobs), (tmemory, tobs)):
        owner = _Owner("Owner#0", 4096)
        mod.LEDGER.track(owner)
        handle = mod.on_pressure(lambda n: None, high=8192)
        owner.nbytes = 10_000
        mod.LEDGER.note(owner)
        snap = {"memory": obs.snapshot()["memory"]}
        texts.append(obs.render_prometheus(snap))
        handle.cancel()
        mod.LEDGER.untrack(owner)
        mod.LEDGER.reset()
    jtext, ttext = texts
    assert "metrics_tpu_memory_tracked_bytes 10000" in ttext
    # HELP lines may name the platform's source of the bytes
    strip = [line for line in ttext.splitlines() if not line.startswith("# HELP")]
    assert strip == [line for line in jtext.splitlines() if not line.startswith("# HELP")]


def test_state_bytes_series_per_metric():
    probs, target = _batch()
    m = T.Accuracy(**CPU)
    m(_arr(T, probs), _arr(T, target))
    snap = tobs.snapshot()
    assert snap["metrics"][m.telemetry_key]["state_memory"] == m.state_memory_report()
    text = tobs.render_prometheus()
    assert f'metrics_tpu_state_bytes{{metric="{m.telemetry_key}"}} {m.state_memory_report()["total_bytes"]}' in text


# -- retrace -------------------------------------------------------------------------


def _retrace_run(pkg, dev):
    m = pkg.Precision(average="macro", num_classes=NC, **dev).jit_forward()
    for n in (8, 8, 9, 10, 11, 12, 8):
        probs, target = _batch(seed=n, n=n)
        m(_arr(pkg, probs), _arr(pkg, target))
    coll = pkg.MetricCollection([pkg.Accuracy(**dev), pkg.Recall(average="macro", num_classes=NC, **dev)])
    probs, target = _batch(n=16)
    coll.update_many(_arr(pkg, probs.reshape(2, 8, NC)), _arr(pkg, target.reshape(2, 8)))
    # the members' own trace counts differ by the JAX package's compute-group
    # fingerprint trace, which the port does not take (ROADMAP queue C)
    return [m, coll]


def _retrace_view(obs, objs):
    snap = obs.snapshot()
    names = {o.telemetry_key: f"m{i}" for i, o in enumerate(objs)}
    counters = [
        {k: v for k, v in snap["metrics"].get(o.telemetry_key, {}).get("counters", {}).items()
         if k in ("jit_forward_compiles", "update_traces", "compute_traces")}
        for o in objs
    ]
    ledger = {names[k]: v for k, v in snap["retrace"]["metrics"].items() if k in names}
    return ledger, counters, snap["retrace"]["threshold"]


def test_retrace_ledger_and_warning_equal_the_jax_package():
    for pkg, dev in ((J, {}), (T, CPU)):
        with pytest.warns(UserWarning, match=r"has compiled its jitted forward 4 times \(threshold 3\)"):
            objs = _retrace_run(pkg, dev)
        if pkg is J:
            want = _retrace_view(jobs, objs)
    got = _retrace_view(tobs, objs)
    assert got == want
    ledger = got[0]["m0"]
    assert ledger["compiles"] == 5 and ledger["warned"] is True
    assert ledger["signatures"] == ["(float32[9,4], int64[9])", "(float32[10,4], int64[10])",
                                    "(float32[11,4], int64[11])", "(float32[12,4], int64[12])"]


def test_retrace_events_and_prometheus_equal_the_jax_package():
    texts, kinds = [], []
    for pkg, dev, obs in ((J, {}, jobs), (T, CPU, tobs)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            objs = _retrace_run(pkg, dev)
        names = {o.telemetry_key: f"m{i}" for i, o in enumerate(objs)}
        snap = obs.snapshot()
        texts.append(obs.render_prometheus({"retrace": {
            "threshold": snap["retrace"]["threshold"],
            "metrics": {names[k]: v for k, v in snap["retrace"]["metrics"].items() if k in names},
        }}))
        kinds.append(sorted((names[e.metric], e.payload["source"]) for e in obs.EVENTS.events()
                            if e.kind == "retrace" and e.metric in names))
    strip = [re.sub(r"Fresh .* dispatches\.", "", t) for t in texts]
    assert strip[1] == strip[0]
    assert kinds[1] == kinds[0]


def test_threshold_setter_and_env_default():
    assert tobs.get_retrace_threshold() == 3
    tobs.set_retrace_threshold(7)
    assert tobs.MONITOR.snapshot()["threshold"] == 7
    with pytest.raises(ValueError, match="retrace threshold"):
        tobs.set_retrace_threshold(0)
    assert tobs.arg_signature(torch.zeros(2, 3, dtype=torch.int32), k=1.0) == jobs.arg_signature(
        np.zeros((2, 3), np.int32), k=1.0
    )
