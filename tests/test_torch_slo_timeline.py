"""The port's SLO plane and Chrome-trace timeline against the JAX package's.

* SLOs: the same histogram observations and window rotations in each
  package's registry give the same statuses (both windows' bad/total counts,
  burn rates, the window percentile, the budget and the breach verdict),
  the same ``breaches()``, the same edge-triggered watchdog ``slo`` events
  and the same ``snapshot()["slo"]`` and ``metrics_tpu_slo_*`` text:
  exactly, since both run the same numpy over the same bucket counts.
* Timeline: the same event sequence, serving spans and memory samples give
  the same Chrome-trace JSON with the timestamps (``ts``, ``dur``, the
  epoch) masked and the producer's package name normalized; the fleet form
  of a given fleet dict is equal exactly. ``export`` and ``export_fleet``
  write JSON that loads back, empty logs included.
"""
import json
import re

import numpy as np
import pytest

import metrics_tpu.observability as jobs
import metrics_tpu_torch.observability as tobs
from metrics_tpu.observability import slo as jslo
from metrics_tpu.observability import timeline as jtimeline
from metrics_tpu_torch.observability import slo as tslo
from metrics_tpu_torch.observability import timeline as ttimeline

PAIRS = ((jobs, jslo, jtimeline), (tobs, tslo, ttimeline))


@pytest.fixture(autouse=True)
def clean():
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
    yield
    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()


# -- SLOs ----------------------------------------------------------------------------

#: (tick time, latencies observed before the tick)
_SCHEDULE = [
    (1.0, [0.01] * 50),
    (2.0, [0.02] * 40 + [0.3] * 2),
    (3.0, [0.5] * 30 + [0.01] * 10),  # burning
    (4.0, [0.5] * 30),
    (6.0, [0.01] * 80),
    (40.0, [0.01] * 100),  # the burn left both windows: recovered
]


def _slo_run(obs, slo_mod, epoch_s=1.0):
    hists = obs.HistogramRegistry()
    hists.set_window_epoch(epoch_s, window_seconds=32.0)
    reg = slo_mod.SLORegistry(histograms=hists)
    dog = slo_mod.SLOWatchdog(registry=reg)
    reg.declare(name="ingest_p99", series="serving_ingest_seconds", threshold=0.1, percentile=99.0,
                fast_window_s=2.0, slow_window_s=8.0)
    reg.declare(slo_mod.SLO("gold_p90", "serving_ingest_seconds", threshold=0.05, percentile=90.0,
                            fast_window_s=1.0, slow_window_s=4.0, labels={"tier": "gold"}))
    hists.rotate(0.0)
    ticks, events_before = [], len(obs.EVENTS.events())
    for now, values in _SCHEDULE:
        for v in values:
            hists.observe("serving_ingest_seconds", v, tier="gold")
            hists.observe("serving_ingest_seconds", v / 2, tier="silver")
        ticks.append(dog.tick(now))
    slo_events = [(e.metric, e.payload) for e in obs.EVENTS.events()[events_before:] if e.kind == "slo"]
    return ticks, reg.breaches(), slo_events, dog.ticks, reg.summary()


def test_slo_statuses_breaches_and_watchdog_events_equal_the_jax_package():
    want, got = (_slo_run(obs, mod) for obs, mod, _ in PAIRS)
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    states = [e[1]["state"] for e in got[2]]
    assert "breach" in states and "recover" in states
    assert got[0][2]["ingest_p99"]["breached"] is True
    assert got[4]["breaches_total"] >= 1


@pytest.mark.parametrize("bad,total,objective", [(0, 0, 0.99), (5, 100, 0.99), (1, 1000, 0.999), (50, 50, 0.9)])
def test_burn_rate(bad, total, objective):
    assert tslo.burn_rate(bad, total, objective) == jslo.burn_rate(bad, total, objective)


def test_slo_declaration_errors_equal_the_jax_package():
    for kwargs in ({"percentile": 100.0}, {"threshold": 0.0}, {"objective": 1.0},
                   {"fast_window_s": 10.0, "slow_window_s": 5.0}):
        args = {"name": "x", "series": "s", "threshold": 0.1, **kwargs}
        with pytest.raises(ValueError) as jerr:
            jslo.SLO(**args)
        with pytest.raises(ValueError) as terr:
            tslo.SLO(**args)
        assert str(terr.value) == str(jerr.value)


def test_slo_snapshot_section_and_prometheus_equal_the_jax_package():
    texts, sections = [], []
    for obs, mod, _ in PAIRS:
        obs.SLO_REGISTRY.declare(name="ingest", series="serving_ingest_seconds", threshold=0.1,
                                 fast_window_s=1.0, slow_window_s=4.0)
        obs.HISTOGRAMS.set_window_epoch(1.0)
        obs.HISTOGRAMS.rotate(100.0)
        for v in [0.01] * 20 + [0.4] * 5:
            obs.HISTOGRAMS.observe("serving_ingest_seconds", v)
        obs.WATCHDOG.tick(100.5)
        section = obs.snapshot()["slo"]
        section.pop("window_epoch_s")
        sections.append(section)
        texts.append(obs.render_prometheus({"slo": obs.snapshot()["slo"]}))
    assert sections[1] == sections[0]
    assert texts[1] == texts[0]
    assert 'metrics_tpu_slo_burn_rate{slo="ingest",series="serving_ingest_seconds",window="fast"}' in texts[1]
    for obs, _, _ in PAIRS:
        obs.reset()
        assert obs.snapshot()["slo"] == {}


def test_a_disabled_watchdog_tick_is_a_no_op():
    tobs.SLO_REGISTRY.declare(name="x", series="s", threshold=0.1)
    tobs.disable()
    assert tobs.WATCHDOG.tick(1.0) == {} and tobs.WATCHDOG.ticks == 0


# -- timeline ------------------------------------------------------------------------


def _mask(trace):
    """Timestamps masked, the producer's package name normalized."""
    text = json.dumps(trace, sort_keys=True).replace("metrics_tpu_torch", "metrics_tpu")
    text = re.sub(r'"(ts|dur|epoch_unix_s)": [-0-9.e]+', r'"\1": 0', text)
    return json.loads(text)


def _fill(obs, timeline_mod, memory_mod):
    log = obs.EventLog(capacity=64)
    tracker = obs.SpanTracker(log=log)
    with log.step_context(3):
        log.record("update", "Accuracy#0", dur_s=0.002, path="eager")
        log.record("forward", "Accuracy#0", dur_s=0.001, path="compiled", compiled_this_call=False)
        log.record("health", "Accuracy#0", source="apply_update", nan=["total"], inf=[], zero_weight=[])
    log.record("retrace", "Precision#1", source="jit_forward", count=1, signature="(float32[8,4], int64[8])")
    log.record("profile", "Precision#1", dur_s=0.0003, path="compiled", phase="host_queue")
    log.record("profile", "Precision#1", dur_s=0.0004, path="compiled", phase="device")
    log.record("sync", None, dur_s=0.004, path="gather", payload_bytes=np.int64(64), shape=(2, 3))
    log.record("slo", "ingest", state="breach", burn_fast=3.5, burn_slow=1.2)
    submit = tracker.record_span("serving", bucket="submit", enter_ago_s=0.01, exit_ago_s=0.009, rows=4)
    dispatch = tracker.record_span("serving", bucket="dispatch", enter_ago_s=0.008, exit_ago_s=0.002,
                                   cohorts=[submit], rows=4)
    tracker.record_span("serving", bucket="read", enter_ago_s=0.001, exit_ago_s=0.0, flush_span=dispatch)
    with tracker.collective_span("gather", group="0,1", bucket="transport"):
        pass
    owner = type("Owner", (), {"telemetry_key": "Owner#0", "state_memory_report": lambda self: {"total_bytes": 512}})()
    memory_mod.LEDGER.track(owner)
    trace = timeline_mod.to_chrome_trace(log=log, tracker=tracker)
    memory_mod.LEDGER.untrack(owner)
    return trace, log, tracker


def test_chrome_trace_equals_the_jax_package_with_times_masked(monkeypatch):
    from metrics_tpu.observability import memory as jmemory
    from metrics_tpu_torch.observability import memory as tmemory

    # fresh ledgers: the process-global ones keep the owners earlier tests tracked
    for mod in (jmemory, tmemory):
        monkeypatch.setattr(mod, "LEDGER", mod.MemoryLedger())
    (jtrace, _, _), (ttrace, _, _) = _fill(jobs, jtimeline, jmemory), _fill(tobs, ttimeline, tmemory)
    assert _mask(ttrace) == _mask(jtrace)
    tracks = {e["args"]["name"] for e in ttrace["traceEvents"] if e["name"] == "thread_name"}
    assert {"Accuracy#0", "Precision#1", "<global>", "ingest", "<serving>"} <= tracks
    phases = {e["ph"] for e in ttrace["traceEvents"]}
    assert {"X", "i", "C", "s", "f", "M"} <= phases
    assert any(e["name"] == "memory.tracked_bytes" for e in ttrace["traceEvents"])


def test_export_writes_json_that_loads_back(tmp_path):
    from metrics_tpu_torch.observability import memory as tmemory

    _, log, tracker = _fill(tobs, ttimeline, tmemory)
    path = ttimeline.export(str(tmp_path / "run" / "timeline.json"), log=log, tracker=tracker)
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["otherData"]["producer"] == "metrics_tpu_torch.observability.timeline"
    tmemory.LEDGER.reset()  # the memory track's samples go too
    empty = ttimeline.export(str(tmp_path / "empty.json"), log=tobs.EventLog(), tracker=tobs.SpanTracker())
    with open(empty) as fh:
        assert [e["name"] for e in json.load(fh)["traceEvents"]] == ["process_name"]


def _fleet():
    span = {"kind": "gather", "group": "0,1", "bucket": "transport", "seq": 0, "payload": {"bytes": 64}}
    return {
        "processes": [
            {"process": p, "epoch_unix": 1.0e9, "events": [
                {"seq": 0, "kind": "update", "metric": "Accuracy#0", "step": 1, "ts_s": 0.5 + p,
                 "dur_s": 0.001, "payload": {"path": "eager"}},
            ], "spans": [
                {**span, "span_id": "gather|0,1|transport|0", "process": p, "enter_s": 1.0 + 0.1 * p,
                 "exit_s": 1.5, "step": None},
                {**span, "span_id": "gather|0,1|transport|1", "seq": 1, "process": p, "enter_s": 2.0 + 0.2 * p,
                 "exit_s": 2.5, "step": 2},
            ]}
            for p in range(3)
        ],
        "clock": {"offsets": [0.0, 0.001, -0.002], "rtt_s": 0.0004, "uncertainty_s": 0.0002, "rounds": 3,
                  "process": 0},
    }


def test_fleet_chrome_trace_equals_the_jax_package():
    fleet = _fleet()
    jreport = jobs.straggler_report(fleet)
    treport = tobs.straggler_report(fleet)
    assert treport == jreport
    got = json.loads(json.dumps(ttimeline.to_fleet_chrome_trace(fleet, treport)).replace("metrics_tpu_torch", "metrics_tpu"))
    want = json.loads(json.dumps(jtimeline.to_fleet_chrome_trace(fleet, jreport)))
    assert got == want
    flows = [e for e in got["traceEvents"] if e.get("cat") == "collective_flow"]
    assert [e["ph"] for e in flows] == ["s", "t", "f", "s", "t", "f"]


def test_export_fleet_in_one_process_loads_back(tmp_path):
    tobs.TRACER.record_span("serving", bucket="submit", enter_ago_s=0.001)
    path = ttimeline.export_fleet(str(tmp_path / "fleet.json"))
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["otherData"]["processes"] == 1
    assert doc["otherData"]["straggler_report"]["collectives"] == 0
    assert tobs.snapshot()["tracing"]["straggler"] == doc["otherData"]["straggler_report"]
