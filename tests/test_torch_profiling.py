"""The port's dispatch profiler and profiler ranges against the JAX package's.

* Sampling: over the same dispatches, ``set_profiling(N)`` samples exactly
  ``ceil(dispatches / N)`` per path, in both packages alike, on every path
  the JAX package brackets (``compiled``, ``update_many``, ``keyed_scatter``,
  ``serving_flush``, ``serving_stage``); a serving flush that drives a keyed
  update samples the flush alone; disarmed, nothing is counted and the
  section stays ``{}``; ``reset`` keeps the stride and ``disable`` disarms.
* Each sample observes both split series once and records the paired
  ``profile`` events; ``profile_report()`` counts the sampled programs and
  reads the cost plane (no XLA figure in the port).
* The snapshot's ``profiling`` section and its Prometheus family equal the
  JAX package's text (the split histograms' time values masked).
* ``utilities/profiling.py``: without an active profiler the ranges are one
  shared no-op; under ``torch.profiler`` a collection forward names every
  member (``metrics/<Metric>.forward``, ``.update``, ``.compute``,
  ``.shared_update``), as the JAX package's ``named_scope`` annotations do;
  the slope harnesses return a float and fill their ``stats``.

On the CPU the device half of a sample is the host time after the submit
(there is no stream); on the card it is two CUDA events around the submit
(``tests/test_torch_card.py``).
"""
import math
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
from metrics_tpu_torch.observability import profiling as tprofiling
from metrics_tpu_torch.utilities import profiling as tutil
from tests.test_torch_serving import _queue, _Recorder

CPU = {"device": "cpu"}
NC = 4
SIDES = ((J, {}, jobs), (T, CPU, tobs))


@pytest.fixture(autouse=True)
def clean():
    for obs in (jobs, tobs):
        obs.set_profiling(0)
        obs.reset()
        obs.enable()
    yield
    for obs in (jobs, tobs):
        obs.set_profiling(0)
        obs.reset()
        obs.enable()


def _arr(pkg, x):
    return jax.numpy.asarray(x) if pkg is J else torch.from_numpy(np.asarray(x))


def _batch(seed=0, n=8):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, NC).astype(np.float32)
    return probs / probs.sum(-1, keepdims=True), rng.randint(0, NC, n)


def _drive(pkg, dev, steps=7):
    """Dispatches on every compiled path a metric user reaches."""
    m = pkg.Precision(average="macro", num_classes=NC, **dev).jit_forward()
    coll = pkg.MetricCollection([pkg.Accuracy(**dev), pkg.Recall(average="macro", num_classes=NC, **dev)])
    km = pkg.KeyedMetric(pkg.MeanSquaredError(**dev), 8, **dev)
    mtc = pkg.MultiTenantCollection([pkg.MeanSquaredError(**dev), pkg.MeanAbsoluteError(**dev)], 8, **dev)
    for i in range(steps):
        probs, target = _batch(seed=i)
        m(_arr(pkg, probs), _arr(pkg, target))
        coll.update_many(_arr(pkg, np.stack([probs, probs])), _arr(pkg, np.stack([target, target])))
        ids = _arr(pkg, target.astype(np.int64))
        km.update(ids, _arr(pkg, probs[:, 0]), _arr(pkg, probs[:, 1]))
        mtc.update(ids, _arr(pkg, probs[:, 0]), _arr(pkg, probs[:, 1]))
    return m, coll, km, mtc


def _split_counts(obs):
    return {
        (name, labels["path"]): hist.count
        for _, hist, labels, name in obs.HISTOGRAMS.series_items()
        if name in (tprofiling.DISPATCH_HOST_QUEUE_SECONDS, tprofiling.DISPATCH_DEVICE_SECONDS)
    }


@pytest.mark.parametrize("every", [1, 3, 10])
def test_sampling_tallies_equal_the_jax_package(every):
    for pkg, dev, obs in SIDES:
        obs.set_profiling(every)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _drive(pkg, dev)
        if pkg is J:
            want = (obs.snapshot()["profiling"], _split_counts(obs))
    got = (tobs.snapshot()["profiling"], _split_counts(tobs))
    assert got == want
    summary = got[0]
    assert summary["dispatches"] == {"compiled": 7, "update_many": 7, "keyed_scatter": 14}
    assert summary["samples"] == {p: math.ceil(n / every) for p, n in summary["dispatches"].items()}
    assert all(n == summary["samples"][path] for (_, path), n in got[1].items())


def test_disarmed_counts_nothing_and_the_section_stays_empty():
    _drive(T, CPU, steps=2)
    assert tobs.snapshot()["profiling"] == {} and _split_counts(tobs) == {}
    assert tobs.PROFILER.begin("compiled", torch.device("cpu")) is None
    tobs.set_profiling(2)
    assert tobs.get_profiling() == 2
    _drive(T, CPU, steps=2)
    tobs.reset()  # the stride survives a reset, the tallies do not
    assert tobs.snapshot()["profiling"] == {"enabled": True, "sample_every": 2, "dispatches": {}, "samples": {}}
    tobs.disable()
    assert tobs.get_profiling() == 0
    with pytest.raises(ValueError, match="sample_every"):
        tobs.set_profiling(-1)


def test_profile_events_and_report():
    tobs.set_profiling(1)
    m, coll, km, mtc = _drive(T, CPU, steps=2)
    events = [(e.metric, e.payload["path"], e.payload["phase"]) for e in tobs.EVENTS.events() if e.kind == "profile"]
    assert events[:2] == [(m.telemetry_key, "compiled", "host_queue"), (m.telemetry_key, "compiled", "device")]
    assert len(events) == 2 * sum(tobs.snapshot()["profiling"]["samples"].values())
    report = tobs.profile_report()
    assert set(report) == set(jobs.profile_report())
    assert set(report["paths"]) == {"compiled", "update_many", "keyed_scatter"}
    entry = report["executables"][f"{m.telemetry_key}:compiled"]
    assert entry == {"path": "compiled", "programs": 1, "available": False}
    assert f"{mtc.telemetry_key}:keyed_scatter" not in report["executables"]  # an eager update: no program


@pytest.mark.parametrize("staging", [False, True])
def test_a_serving_flush_samples_the_flush_and_not_its_keyed_update(staging):
    out = []
    for pkg, dev, obs in SIDES:
        obs.set_profiling(1)
        km = pkg.KeyedMetric(pkg.MeanSquaredError(**dev), 8, **dev)
        q = _queue("jax" if pkg is J else "torch", km.update, max_batch=8, staging=staging)
        rng = np.random.RandomState(0)
        for _ in range(3):
            q.submit_many(rng.randint(0, 8, 8), rng.rand(8).astype(np.float32), rng.rand(8).astype(np.float32))
            q.flush()
        q.close()
        out.append(obs.snapshot()["profiling"])
    assert out[1] == out[0]
    assert out[1]["samples"]["serving_flush"] == 3 and "keyed_scatter" not in out[1]["samples"]
    assert ("serving_stage" in out[1]["samples"]) is staging


def test_a_recording_target_flush_is_sampled_host_only():
    tobs.set_profiling(1)
    q = _queue("torch", _Recorder(), max_batch=4)
    q.submit_many(np.arange(4), np.ones(4, np.float32))
    q.flush()
    q.close()
    assert tobs.snapshot()["profiling"]["samples"] == {"serving_flush": 1}


def test_prometheus_profiling_family_equals_the_jax_package():
    texts = []
    for pkg, dev, obs in SIDES:
        obs.set_profiling(2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _drive(pkg, dev, steps=3)
        snap = obs.snapshot()
        hists = {k: v for k, v in snap["histograms"].items() if k.startswith("dispatch_host_queue_seconds")
                 or k.startswith("dispatch_device_seconds")}
        texts.append(obs.render_prometheus({"profiling": snap["profiling"], "histograms": hists}))
    time_series = re.compile(r"^metrics_tpu_dispatch_(host_queue|device)_seconds_(bucket|sum)\b")

    def masked(text):
        return [re.sub(r" \S+$", " <t>", line) if time_series.match(line) else line for line in text.splitlines()
                if not line.startswith("# HELP metrics_tpu_dispatch_device_seconds")]

    assert masked(texts[1]) == masked(texts[0])
    assert "metrics_tpu_profiling_samples_total" in texts[1]


# -- profiler ranges -----------------------------------------------------------------


def test_the_ranges_are_a_no_op_without_a_profiler():
    assert tutil.compiled_scope("X.update") is tutil.eager_span("Y.forward")


def test_a_torch_profiler_trace_names_every_member():
    probs, target = _batch()
    coll = T.MetricCollection({
        "Accuracy": T.Accuracy(**CPU), "Precision": T.Precision(average="macro", num_classes=NC, **CPU),
        "Recall": T.Recall(average="macro", num_classes=NC, **CPU),
    })
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        coll(_arr(T, probs), _arr(T, target))
        T.MeanSquaredError(**CPU).jit_forward()(_arr(T, probs[:, 0]), _arr(T, probs[:, 1]))
    names = {e.key for e in prof.key_averages() if e.key.startswith("metrics/")}
    assert {"metrics/Accuracy.forward", "metrics/Precision.forward", "metrics/Recall.forward",
            "metrics/MeanSquaredError.forward", "metrics/Precision.shared_update",
            "metrics/MeanSquaredError.update", "metrics/MeanSquaredError.compute"} <= names


def test_the_slope_harnesses_return_a_float():
    m = T.MeanSquaredError(**CPU)
    xs = (torch.rand(4, 16), torch.rand(4, 16))
    stats = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        slope = tutil.measure_scan_slope(xs, m.init_state, m.apply_update, rounds=3, stats=stats)
        overhead = tutil.measure_step_overhead(m, torch.rand(16), torch.rand(16), steps=4, rounds=3)
    assert isinstance(slope, float) and isinstance(overhead, float)
    assert set(stats) == {"warmup_short_s", "warmup_long_s"}
    assert not m._jit_forward_enabled  # the overhead runs on a clone
