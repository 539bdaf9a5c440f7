"""``merged_leaves_per_update`` in a small traced run of the keyed cell on the
CPU: the two bundles' eleven int32 leaves take the merge on every window
update, and a program whose requests carry no ``merged_leaves``, as an older
one's do not, gives no metric."""
import pytest

from portbench import common, host_spans
from portbench.tests.helpers import run_small

CELL = "keyed_tenants.cohorts"
NAME = "merged_leaves_per_update"


@pytest.fixture()
def tracer():
    from metrics_tpu_torch import observability

    observability.reset()
    yield observability.TRACER
    observability.reset()
    observability.enable()


def _reader():
    return common.load_module(common.HERE / "layers" / f"{NAME}.py", f"probe_{NAME}")


def test_every_leaf_of_both_bundles_takes_the_merge_on_every_update(tracer):
    record = run_small(CELL, seconds=0.3, trace=True)
    assert common.read_layers(record)[NAME] == {"value": 11.0, "unit": "leaves"}
    window = host_spans.requests(record)
    assert [r.merged_leaves for r in window] == [11] * len(window)


def test_requests_without_the_count_give_no_metric(tracer, monkeypatch):
    record = run_small(CELL, seconds=0.3, trace=True)
    older = [r._asdict() for r in host_spans.requests(record)]
    for r in older:
        del r["merged_leaves"]
    monkeypatch.setattr(host_spans, "requests", lambda _: [type("Request", (), r)() for r in older])
    assert _reader().read(record) is None
    monkeypatch.undo()
    monkeypatch.setattr(host_spans, "_tracer", lambda: None)  # no host requests at all
    assert _reader().read(record) is None
