"""The six per-layer metrics read from the program's host requests in a small
traced run of the keyed cell on the CPU: all present, the five times summing
to the mean ``keyed.update`` request over the same requests, a whole number
of host reads, and the window's updates alone counted: none of the warm
epoch or of the profiled passes."""
from collections import deque

import pytest

from portbench import common, host_spans
from portbench.tests.helpers import run_small

CELL = "keyed_tenants.cohorts"
TIMES = ("update_checks_ms", "update_host_read_ms", "update_rows_ms", "update_scatter_ms", "update_rest_ms")


@pytest.fixture()
def tracer():
    from metrics_tpu_torch import observability

    observability.reset()
    yield observability.TRACER
    observability.reset()
    observability.enable()


def _requests(tracer, profiled):
    return [r for r in tracer.host_records() if r.name == "keyed.update" and r.profiled is profiled]


def test_the_six_metrics_split_the_keyed_update(tracer):
    record = run_small(CELL, seconds=0.5, trace=True)
    metrics = common.read_layers(record)
    assert set(TIMES) | {"host_reads_per_update"} <= set(metrics)
    window = host_spans.requests(record)
    mean_update_ms = 1e3 * sum(r.exit_s - r.enter_s for r in window) / len(window)
    assert sum(metrics[name]["value"] for name in TIMES) == pytest.approx(mean_update_ms, rel=1e-9)
    assert all(metrics[name]["value"] >= 0 for name in TIMES)
    reads = metrics["host_reads_per_update"]["value"]
    assert reads == int(reads) == 2  # one target range a bundle; float preds read none

    # the window: every one of its N updates, the warm epoch's requests
    # before them and the profiled passes' after them
    n = len(record.spans["update"])
    cohorts = record.cell.cfg["cohorts"]
    unprofiled, profiled = _requests(tracer, False), _requests(tracer, True)
    assert len(window) == n and len(unprofiled) == cohorts + n
    assert [r.request for r in window] == [r.request for r in unprofiled[cohorts:]]
    assert len(profiled) == record.cell.traffic["profile_epochs"] * cohorts
    assert window[-1].exit_s < profiled[0].enter_s
    # each request holds the benchmark's update span: a little longer, never shorter
    assert 1e3 * sum(record.spans["update"]) / n >= mean_update_ms


def test_nothing_to_read_gives_no_metric(tracer, monkeypatch):
    record = run_small(CELL, seconds=0.3, trace=True)
    assert host_spans.split(record) is not None
    # a ring that holds fewer requests than the window: the last of them
    held = _requests(tracer, False)[-2:]
    monkeypatch.setattr(tracer, "_host", deque(held + _requests(tracer, True), maxlen=len(held) + 100))
    assert [r.request for r in host_spans.requests(record)] == [r.request for r in held]
    # a program without host requests, as the parent commit is
    monkeypatch.setattr(host_spans, "_tracer", lambda: None)
    assert all(common.load_module(common.HERE / "layers" / f"{name}.py", f"probe_{name}").read(record) is None
               for name in TIMES + ("host_reads_per_update",))
