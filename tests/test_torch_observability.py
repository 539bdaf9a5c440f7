"""The port's telemetry core against the JAX package's.

The same seeded numpy call sequences go through the JAX objects and the
port's (``device="cpu"``), each package recording into its own process-global
registry, event log, histograms and span tracker (both reset first). Keys
carry process-wide ordinals, so the two snapshots are compared object by
object: the JAX object's entry against its port counterpart's.

* Counters after update/forward/compute/reset on one metric, a composition,
  an ImageNet-style collection at C = 5, a sketched curve and a keyed
  collection (``validate_ids=False``, invalid ids) are equal exactly. Timers
  are excluded, and so is the keyed objects' ``jit_forward_compiles``:
  every JAX keyed update compiles, where the port's stays eager until
  ``warmup``/``jit_forward`` (ROADMAP queue C). ``update_traces`` and
  ``compute_traces`` are compared.
* The events' kinds and paths come out in the same order (the JAX
  package's ``retrace`` events, which its compiles record, left out).
* ``Log2Histogram``/``HistogramWindow`` give the same buckets, percentiles
  and ring rotation for the same values.
* ``render_prometheus()`` gives the same text once the time-valued series
  are masked and the JAX snapshot is cut to the sections the port covers.
* ``enable``/``disable``/``reset`` behave the same; with telemetry disabled
  the instrumented ``forward``/``update``/``compute`` read no clock.
* ``snapshot()["kernels"]`` counts the CPU's ``"torch"`` dispatches.
"""
import re
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.observability as jobs
from metrics_tpu.kernels import _common as jcommon
import metrics_tpu_torch as T
import metrics_tpu_torch.observability as tobs
from metrics_tpu_torch.kernels import _common as tcommon

CPU = {"device": "cpu"}
C = 5
#: the JAX package's counter that the keyed call sequences set on its side
#: only: every JAX keyed update compiles, where the port's keyed update stays
#: eager until ``warmup``/``jit_forward`` (ROADMAP queue C)
_COMPILE_COUNTERS = {"jit_forward_compiles"}
_KEYED_SEQUENCES = ("keyed", "keyed_metric")


@pytest.fixture(autouse=True)
def clean_telemetry():
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
    yield
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _batches(seed=0, n=24, batches=3):
    rng = np.random.RandomState(seed)
    return [(_softmax(rng.randn(n, C)), rng.randint(0, C, n)) for _ in range(batches)]


def _args(pkg, batch):
    conv = jnp.asarray if pkg is J else torch.from_numpy
    return [conv(np.asarray(a)) for a in batch]


# -- the call sequences, each run on both packages -----------------------------------
# each returns the objects whose entries are compared, in the same order


def _seq_metric(pkg, dev):
    m = pkg.Precision(average="macro", num_classes=C, **dev)
    batches = _batches(1)
    for batch in batches[:2]:
        m(*_args(pkg, batch))
    m.update(*_args(pkg, batches[2]))
    m.compute()
    m.compute()  # cached: counts a call, computes nothing
    m.reset()
    return [m]


def _seq_composition(pkg, dev):
    p = pkg.Precision(average="macro", num_classes=C, **dev)
    r = pkg.Recall(average="macro", num_classes=C, **dev)
    comp = 2 * p * r / (p + r)
    batches = _batches(2)
    comp(*_args(pkg, batches[0]))
    for batch in batches[1:]:
        comp.update(*_args(pkg, batch))
    comp.compute()
    comp.reset()
    return [comp, p, r]


def _collection(pkg, dev):
    kw = dict(average="macro", num_classes=C, **dev)
    return pkg.MetricCollection({
        "Accuracy": pkg.Accuracy(**dev), "Precision": pkg.Precision(**kw), "Recall": pkg.Recall(**kw),
        "F1": pkg.F1(**kw), "Specificity": pkg.Specificity(**kw), "ConfusionMatrix": pkg.ConfusionMatrix(C, **dev),
        "IoU": pkg.IoU(C, **dev), "CohenKappa": pkg.CohenKappa(C, **dev),
        "MatthewsCorrcoef": pkg.MatthewsCorrcoef(C, **dev),
    })


def _seq_collection(pkg, dev):
    coll = _collection(pkg, dev)
    batches = _batches(3, batches=5)
    for batch in batches[:3]:
        coll(*_args(pkg, batch))
    coll.compute()
    for batch in batches[3:]:
        coll.update(*_args(pkg, batch))
    coll.compute()
    coll.reset()
    return [m for _, m in coll.items(keep_base=True)]


def _seq_sketch(pkg, dev):
    m = pkg.AUROC(num_classes=C, sketched=True, num_bins=64, **dev)
    for batch in _batches(4):
        m(*_args(pkg, batch))
    m.compute()
    return [m]


def _keyed_batches(n=7):
    rng = np.random.RandomState(5)
    out = []
    for rows in (40, 33, 21):
        ids = rng.randint(-2, n + 3, rows)  # some ids below 0 and past n
        out.append((ids, _softmax(rng.randn(rows, C)), rng.randint(0, C, rows)))
    return out


def _seq_keyed(pkg, dev):
    kw = dict(average="macro", num_classes=C, **dev)
    members = {"Accuracy": pkg.Accuracy(**dev), "Precision": pkg.Precision(**kw), "Recall": pkg.Recall(**kw)}
    keyed = pkg.MultiTenantCollection(members, 7, validate_ids=False, **dev)
    for batch in _keyed_batches():
        keyed.update(*_args(pkg, batch))
    keyed.compute()
    keyed.reset()
    if pkg is J:
        jax.effects_barrier()  # the invalid-id counter's host callbacks
    return [keyed, keyed._collection, *keyed._keyed.values()]


def _seq_keyed_metric(pkg, dev):
    km = pkg.KeyedMetric(pkg.Accuracy(**dev), 7, validate_ids=False, **dev)
    for ids, preds, target in _keyed_batches():
        km.update(*_args(pkg, (ids, preds, target)))
    km.compute()
    km.reset(_args(pkg, (np.array([0, 3]),))[0])
    if pkg is J:
        jax.effects_barrier()
    return [km]


SEQUENCES = {
    "metric": _seq_metric,
    "composition": _seq_composition,
    "collection": _seq_collection,
    "sketch": _seq_sketch,
    "keyed": _seq_keyed,
    "keyed_metric": _seq_keyed_metric,
}


def _run_both(seq):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return SEQUENCES[seq](J, {}), SEQUENCES[seq](T, CPU)


def _entry(snap, obj):
    return snap["metrics"].get(obj.telemetry_key, {"counters": {}})


@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_counters_equal_the_jax_package_after_the_same_calls(seq):
    jax_objs, port_objs = _run_both(seq)
    jsnap, tsnap = jobs.snapshot(), tobs.snapshot()
    assert len(jax_objs) == len(port_objs)
    for jo, to in zip(jax_objs, port_objs):
        skip = _COMPILE_COUNTERS if seq in _KEYED_SEQUENCES else set()
        want = {k: v for k, v in _entry(jsnap, jo)["counters"].items() if k not in skip}
        assert _entry(tsnap, to)["counters"] == want, (type(to).__name__, seq)
        assert _entry(tsnap, to).get("info", {}) == _entry(jsnap, jo).get("info", {}), type(to).__name__
        assert sorted(_entry(tsnap, to).get("timers", {})) == sorted(_entry(jsnap, jo).get("timers", {}))


def test_the_keyed_collection_counts_its_invalid_rows():
    jax_objs, port_objs = _run_both("keyed")
    n = 7
    want = sum(int(((ids < 0) | (ids >= n)).sum()) for ids, _, _ in _keyed_batches(n))
    assert want > 0
    assert tobs.TELEMETRY.counter(port_objs[0].telemetry_key, "invalid_tenant_ids") == want
    assert jobs.TELEMETRY.counter(jax_objs[0].telemetry_key, "invalid_tenant_ids") == want


def test_invalid_ids_stay_on_the_device_until_a_snapshot_asks():
    km = T.KeyedMetric(T.Accuracy(**CPU), 4, validate_ids=False, **CPU)
    ids, preds, target = _keyed_batches(4)[0]
    km.update(*_args(T, (ids, preds, target)))
    km.update(*_args(T, (ids, preds, target)))
    # one device-side accumulator per key and counter, not yet a counter
    assert list(tobs.TELEMETRY._pending) == [(km.telemetry_key, "invalid_tenant_ids")]
    assert "invalid_tenant_ids" not in tobs.TELEMETRY._metrics.get(km.telemetry_key, {}).get("counters", {})
    want = 2 * int(((ids < 0) | (ids >= 4)).sum())
    assert tobs.snapshot()["metrics"][km.telemetry_key]["counters"]["invalid_tenant_ids"] == want
    assert not tobs.TELEMETRY._pending


def test_a_batch_of_valid_ids_creates_no_invalid_counter():
    km = T.KeyedMetric(T.Accuracy(**CPU), 4, validate_ids=False, **CPU)
    km.update(*_args(T, (np.array([0, 1, 3]), _softmax(np.ones((3, C))), np.array([0, 1, 2]))))
    assert "invalid_tenant_ids" not in tobs.snapshot()["metrics"][km.telemetry_key]["counters"]


@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_events_come_out_in_the_same_order(seq):
    _run_both(seq)

    def kinds(log):
        return [(e.kind, e.payload.get("path")) for e in log.events() if e.kind != "retrace"]

    assert kinds(tobs.EVENTS) == kinds(jobs.EVENTS)
    want = {k: n for k, n in jobs.EVENTS.summary()["by_kind"].items() if k != "retrace"}
    assert tobs.EVENTS.summary()["by_kind"] == want


def test_events_carry_the_step_tag():
    m = T.Accuracy(**CPU)
    with tobs.step_context(7):
        m(*_args(T, _batches()[0]))
    tobs.set_step(9)
    m.compute()
    tobs.set_step(None)
    assert [(e.kind, e.step) for e in tobs.EVENTS.events()] == [("compute", 7), ("forward", 7), ("compute", 9)]


# -- histograms ----------------------------------------------------------------------


_VALUES = [3e-6, 1.5e-5, 2e-4, 2e-4, 7e-3, 0.25, 3.0, 50.0, 0.0, -1.0]


@pytest.mark.parametrize("unit", ["s", "bytes", "count"])
def test_log2_histograms_equal_the_jax_package(unit):
    scale = 1.0 if unit == "s" else 4096.0
    hists = [obs.Log2Histogram(unit, window_epoch_s=1.0) for obs in (jobs, tobs)]
    for i, value in enumerate(_VALUES):
        for h in hists:
            h.observe(value * scale)
            if i % 3 == 2:
                h.rotate()
    want = hists[0].to_dict(window_seconds=2.0)
    assert hists[1].to_dict(window_seconds=2.0) == want
    for seconds in (1.0, 3.0, 100.0):
        assert hists[1].window(seconds).to_dict() == hists[0].window(seconds).to_dict()
    assert type(hists[1].window(1.0)) is tobs.HistogramWindow


def test_histogram_registry_rotation_equals_the_jax_package():
    regs = [obs.HistogramRegistry() for obs in (jobs, tobs)]
    for reg in regs:
        reg.set_window_epoch(0.5, window_seconds=1.0)
        reg.rotate(10.0)
        for i, v in enumerate(_VALUES):
            reg.observe("dispatch_seconds", abs(v), path="keyed_scatter")
            if i == 4:
                assert reg.rotate(11.2) == 2
        reg.rotate(11.3)
    snaps = [reg.snapshot() for reg in regs]
    assert snaps[1] == snaps[0]
    from metrics_tpu.observability.histogram import WINDOW_RING_EPOCHS as JRING
    from metrics_tpu_torch.observability.histogram import WINDOW_RING_EPOCHS as TRING

    assert TRING == JRING


# -- Prometheus ----------------------------------------------------------------------

#: series whose values are host times, masked before the texts are compared
_TIME_SERIES = re.compile(
    r"^(metrics_tpu_(eager_seconds|dispatch_seconds|sync_round_trip_seconds)_(bucket|sum)"
    r"|metrics_tpu_sync_(descriptor|payload)_seconds_total)\b"
)
#: sections left out of the comparison: those the port does not record yet,
#: the serving, async and resilience planes (held in their own test files;
#: these sequences do not touch them) and the kernels
_JAX_ONLY = ("retrace", "health", "async_sync", "serving", "durability", "resilience", "slo", "profiling",
             "memory", "kernels")


def _canonical(snap, objs):
    """``snap`` with each compared object's key renamed to its position, the
    JAX-only sections, ``state_memory`` entries, compile counters and
    ``retrace`` events dropped, and the kernels section left out (its paths
    are named per package)."""
    names = {o.telemetry_key: f"m{i}" for i, o in enumerate(objs)}
    out = {k: v for k, v in snap.items() if k not in _JAX_ONLY}
    out["metrics"] = {
        names[k]: {f: v for f, v in e.items() if f != "state_memory"}
        for k, e in snap["metrics"].items()
        if k in names
    }
    for entry in out["metrics"].values():
        entry["counters"] = {k: v for k, v in entry["counters"].items() if k not in _COMPILE_COUNTERS}
    # the JAX package's compiles also record "retrace" events
    events = dict(out["events"])
    retraces = events.get("by_kind", {}).get("retrace", 0)
    if retraces:
        assert events["dropped"] == 0
        events["by_kind"] = {k: n for k, n in events["by_kind"].items() if k != "retrace"}
        events["recorded_total"] -= retraces
        events["high_water"] -= retraces
    out["events"] = events
    return out


def _masked(text):
    return [re.sub(r" \S+$", " <t>", line) if _TIME_SERIES.match(line) else line for line in text.splitlines()]


@pytest.mark.parametrize("seq", ["collection", "sketch", "keyed"])
def test_prometheus_text_equals_the_jax_package_with_times_masked(seq):
    jax_objs, port_objs = _run_both(seq)
    jtext = jobs.render_prometheus(_canonical(jobs.snapshot(), jax_objs))
    ttext = tobs.render_prometheus(_canonical(tobs.snapshot(), port_objs))
    assert "metrics_tpu_calls_total" in ttext
    assert _masked(ttext) == _masked(jtext)


def test_prometheus_renders_the_kernel_dispatch_counts():
    tcommon.reset_dispatch_counters()
    _run_both("collection")
    text = tobs.render_prometheus()
    assert 'metrics_tpu_kernel_dispatch_total{op="stat_scores_counts",path="torch"}' in text
    assert "# TYPE metrics_tpu_kernel_dispatch_total counter" in text


def test_snapshot_is_json_and_has_the_port_sections():
    import json

    _run_both("keyed")
    snap = json.loads(tobs.dumps())
    assert snap["schema"] == jobs.snapshot()["schema"] == 1
    # every section of the JAX package's
    assert set(snap) == set(jobs.snapshot())
    assert "dispatch_seconds{path=keyed_scatter}" in snap["histograms"]
    assert snap["tracing"]["straggler"] is None


# -- enable / disable / reset --------------------------------------------------------


@pytest.mark.parametrize("seq", ["metric", "keyed"])
def test_disable_enable_and_reset_behave_as_in_the_jax_package(seq):
    for obs in (jobs, tobs):
        obs.disable()
        assert not (obs.TELEMETRY.enabled or obs.EVENTS.enabled or obs.TRACER.enabled)
    jax_objs, port_objs = _run_both(seq)
    jsnap, tsnap = jobs.snapshot(), tobs.snapshot()
    assert tsnap["enabled"] is jsnap["enabled"] is False
    assert [_entry(tsnap, o)["counters"] for o in port_objs] == [_entry(jsnap, o)["counters"] for o in jax_objs]
    assert all(not _entry(tsnap, o)["counters"] for o in port_objs)
    assert tobs.EVENTS.summary()["recorded_total"] == jobs.EVENTS.summary()["recorded_total"] == 0

    for obs in (jobs, tobs):
        obs.enable()
        obs.set_step(4)
    keys = [o.telemetry_key for o in port_objs]
    jax_objs, port_objs = _run_both(seq)
    assert tobs.snapshot()["metrics"] and jobs.snapshot()["metrics"]
    for obs in (jobs, tobs):
        obs.reset()
    tsnap, jsnap = tobs.snapshot(), jobs.snapshot()
    assert tsnap["metrics"] == jsnap["metrics"] == {}
    assert tsnap["events"]["recorded_total"] == jsnap["events"]["recorded_total"] == 0
    assert tsnap["events"]["step"] == jsnap["events"]["step"] == 4  # the step tag survives a reset
    assert tsnap["histograms"] == jsnap["histograms"] == {}
    for obs in (jobs, tobs):
        obs.set_step(None)
    # keys survive a reset; new objects take the next ordinals
    assert all(re.fullmatch(r"\w+#\d+", k) for k in keys)


def test_disabled_telemetry_reads_no_clock(monkeypatch):
    calls = [0]
    real = time.perf_counter

    def counting():
        calls[0] += 1
        return real()

    metric = T.Precision(average="macro", num_classes=C, **CPU)
    coll = _collection(T, CPU)
    comp = T.Precision(average="macro", num_classes=C, **CPU) + T.Recall(average="macro", num_classes=C, **CPU)
    keyed = T.MultiTenantCollection({"Accuracy": T.Accuracy(**CPU)}, 7, validate_ids=False, **CPU)
    batch = _args(T, _batches()[0])
    keyed_batch = _args(T, _keyed_batches()[0])

    def drive():
        metric(*batch)
        metric.update(*batch)
        metric.compute()
        coll(*batch)
        coll.update(*batch)
        coll.compute()
        comp(*batch)
        comp.compute()
        keyed.update(*keyed_batch)

    tobs.disable()
    monkeypatch.setattr(time, "perf_counter", counting)
    drive()
    assert calls[0] == 0
    tobs.enable()
    drive()
    assert calls[0] > 0


# -- kernels -------------------------------------------------------------------------


def test_snapshot_kernels_counts_the_cpu_dispatches():
    """Five collection batches: B1 and B2 once per batch (the shared class
    and the confusion-matrix class); three keyed updates: the merge once for
    both bundles' leaves (where the JAX package's path scatters each bundle
    once) and B1 once for the macro bundle's rows (one stacked dispatch);
    three sketched batches: B5 once each. Where the JAX package's path calls
    the same op as often (the histograms), its ``"xla"`` count is the same."""
    tcommon.reset_dispatch_counters()
    jcommon.reset_dispatch_counters()
    for seq in ("collection", "keyed", "sketch"):
        _run_both(seq)
    port = tobs.snapshot()["kernels"]["dispatch"]
    ref = jobs.snapshot()["kernels"]["dispatch"]
    assert port == {
        "stat_scores_counts": {"torch": 5 + 3},
        "confmat_counts": {"torch": 5},
        "segment_merge": {"torch": 3},
        "label_score_histograms": {"torch": 3},
    }
    assert ref["segment_scatter_add"] == {"xla": 2 * port["segment_merge"]["torch"]}
    assert ref["label_score_histograms"] == {"xla": port["label_score_histograms"]["torch"]}
    assert all(tcommon.launch_count(op) == 0 for op in port)  # no card: no launch
