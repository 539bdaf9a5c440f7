"""Host spans inside the port's keyed update (``TRACER.span``) and the
host-read counter (``utilities/data.py::to_host``).

* One ``MultiTenantCollection.update`` is one request, ``keyed.update``,
  holding a ``checks`` (with its ``host_read``), ``row_states`` and
  ``scatter`` span per state bundle; the phases' self times sum to the
  request's length. ``KeyedMetric.update`` the same with one bundle; a
  compiled update is a request with ``path="compiled"`` and no phase inside.
* ``host_reads`` counts the reads of tensor values to the host: on the keyed
  update's path every form of read (``tolist``, ``item``, ``int``,
  ``float``, ``bool``, ``numpy``...) is a ``to_host`` read, and an AST scan
  of the package keeps every written read on ``to_host``.
* Disabled with no profiler running, a span is one shared null context and
  nothing is recorded; under ``torch.profiler`` the spans are
  ``metrics/<name>`` ranges nested as the spans are, in an exported Chrome
  trace too, and the records say ``profiled``.
* The rings are bounded deques that count what they drop; the collective
  ledger (``records()``) and the event log do not change with host spans.
* One eager ``MetricCollection.update`` is one request,
  ``collection.update``, holding a ``shared_update`` span per shared-update
  class, a ``member_update`` span per member, and ``checks`` and
  ``host_read`` spans where they run; its ``shared_members`` attr counts
  the members fed shared deltas. Its inner spans are phases
  (``TRACER.phase``): outside a request, disabled, or directly inside a
  span of their own name they record nothing, so a keyed update keeps
  exactly its phases and a compiled ``update_many`` records nothing.
"""
import ast
import json
import threading
import time
from collections import Counter, deque
from pathlib import Path

import pytest
import torch

import metrics_tpu_torch as T
import metrics_tpu_torch.observability as tobs
from metrics_tpu_torch.observability import tracing
from metrics_tpu_torch.observability.tracing import DEFAULT_HOST_CAPACITY, SpanTracker
from metrics_tpu_torch.utilities import data as tdata
from metrics_tpu_torch.utilities import stacked as tstacked
from metrics_tpu_torch.wrappers import multitenant as tmultitenant

CPU = {"device": "cpu"}
NC, TENANTS, ROWS = 5, 8, 32
PACKAGE = Path(T.__file__).resolve().parent
PHASES = {"checks", "row_states", "scatter", "host_read"}


@pytest.fixture(autouse=True)
def clean():
    tobs.reset()
    tobs.enable()
    yield
    tobs.reset()
    tobs.enable()


def _batch(seed=0, rows=ROWS):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, TENANTS, (rows,), generator=g)
    preds = torch.softmax(torch.randn(rows, NC, generator=g), -1)
    target = torch.randint(0, NC, (rows,), generator=g)
    return ids, preds, target


def _collection(**kw):
    return T.MultiTenantCollection([
        T.Accuracy(**CPU), T.Precision(average="macro", num_classes=NC, **CPU),
        T.Recall(average="macro", num_classes=NC, **CPU),
    ], num_tenants=TENANTS, **CPU, **kw)


def _request(name="keyed.update"):
    (request,) = tobs.TRACER.host_records()
    assert request.name == name
    return request


def _check_request(request, bundles, extra_reads=0):
    assert set(request.phases) == {"keyed.update"} | PHASES
    # checks, row_states and a host_read a bundle, and one scatter for the update
    assert request.spans == 1 + 3 * bundles + 1 + extra_reads
    assert request.host_reads == bundles + extra_reads
    assert all(v >= 0 for v in request.phases.values())
    # the self times partition the request
    assert sum(request.phases.values()) == pytest.approx(request.exit_s - request.enter_s, rel=1e-9, abs=1e-12)
    assert not request.profiled
    assert request.thread == threading.get_ident()


@pytest.mark.parametrize("validate_ids", [False, True])
def test_a_collection_update_records_its_phases_under_one_request(validate_ids):
    coll = _collection(validate_ids=validate_ids)
    coll.update(*_batch())
    request = _request()
    assert request.request == "keyed.update|0"
    assert request.attrs == {"bundles": 2, "path": "eager", "rows": ROWS}
    # each bundle reads its target's range; validate_ids reads the ids' range once more
    _check_request(request, bundles=2, extra_reads=int(validate_ids))
    # Accuracy's seven int32 leaves and the macro bundle's four in one merge
    assert request.merged_leaves == 11 and tobs.TRACER.summary()["host"]["merged_leaves"] == 11


def test_a_keyed_metric_update_records_one_bundle():
    km = T.KeyedMetric(T.Accuracy(**CPU), TENANTS, validate_ids=False, **CPU)
    km.update(*_batch())
    request = _request()
    assert request.attrs == {"bundles": 1, "path": "eager", "rows": ROWS}
    _check_request(request, bundles=1)
    assert request.merged_leaves == 7


def test_nested_spans_add_their_self_times_to_the_request():
    tracker = SpanTracker()
    with tracker.span("outer", k=1) as outer:
        time.sleep(0.002)
        with tracker.span("a"):
            time.sleep(0.002)
            with tracker.span("b"):
                time.sleep(0.002)
        with tracker.span("a"):
            pass
        outer.note(rows=3)
    (request,) = tracker.host_records()
    assert request.attrs == {"k": 1, "rows": 3} and request.spans == 4 and request.host_reads == 0
    assert set(request.phases) == {"outer", "a", "b"}
    assert sum(request.phases.values()) == pytest.approx(request.exit_s - request.enter_s, rel=1e-9)
    assert all(request.phases[n] >= 0.002 for n in ("outer", "a", "b"))
    assert request.phases["a"] < request.phases["a"] + request.phases["b"] < request.exit_s - request.enter_s


def test_a_compiled_update_is_one_span_with_no_phase_inside():
    coll = _collection(validate_ids=False)
    batch = _batch()
    coll.warmup(*batch)
    tobs.TRACER.clear()
    for seed in range(2):
        coll.update(*_batch(seed))
    requests = tobs.TRACER.host_records()
    assert [r.name for r in requests] == ["keyed.update", "keyed.update"]
    assert all(r.attrs["path"] == "compiled" for r in requests)
    assert all(set(r.phases) == {"keyed.update"} and r.spans == 1 and r.host_reads == 0 for r in requests)


#: every way a tensor's values reach Python or numpy
READ_FORMS = ("tolist", "item", "__int__", "__float__", "__bool__", "__index__", "numpy", "__array__")


def test_host_reads_count_every_read_to_the_host(monkeypatch):
    reads = Counter()
    for form in READ_FORMS:
        def counted(self, *a, _read=getattr(torch.Tensor, form), _form=form, **k):
            reads[_form] += 1
            return _read(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, form, counted)
    coll = _collection()
    for seed in range(3):
        coll.update(*_batch(seed))
    T.KeyedMetric(T.Accuracy(**CPU), TENANTS, **CPU).update(*_batch())
    requests = tobs.TRACER.host_records()
    host = tobs.TRACER.summary()["host"]
    # an update reads its ids' range and each bundle's target range, all as tolist
    assert reads == Counter(tolist=3 * 3 + 2)
    assert host["host_reads"] == sum(r.host_reads for r in requests) == 3 * 3 + 2
    assert [r.host_reads for r in requests] == [3, 3, 3, 2]


def test_to_host_returns_what_tolist_returns():
    t = torch.tensor([[1, 2], [3, 4]])
    assert tdata.to_host(t) == t.tolist()
    assert tdata.to_host(torch.tensor(2.5)) == 2.5
    assert (tdata.to_host(t, numpy=True) == t.numpy()).all()
    assert tdata.to_host(t, numpy=True).dtype == t.numpy().dtype
    assert tobs.TRACER.summary()["host"]["host_reads"] == 4
    # outside any request, a read is a request of its own
    assert [(r.name, r.host_reads, r.spans) for r in tobs.TRACER.host_records()] == [("host_read", 1, 1)] * 4
    tobs.disable()
    assert tdata.to_host(t) == t.tolist()
    assert tobs.TRACER.summary()["host"]["host_reads"] == 4 and len(tobs.TRACER.host_records()) == 4


def test_disabled_a_span_is_one_shared_null_context_and_records_nothing():
    tobs.disable()
    assert tobs.TRACER.span("a") is tobs.TRACER.span("b", x=1) is tracing.span("c")
    with tobs.TRACER.span("a") as s:
        s.note(rows=1)
    _collection().update(*_batch())
    assert tobs.TRACER.host_records() == []
    assert tobs.TRACER.summary()["host"] == {"capacity": DEFAULT_HOST_CAPACITY, "size": 0, "recorded": 0,
                                              "dropped": 0, "host_reads": 0, "rows_batched": 0,
                                              "merged_leaves": 0}


@pytest.mark.parametrize("tracer_on", [True, False])
def test_under_a_profiler_the_spans_are_nested_ranges(tracer_on, tmp_path):
    coll = _collection(validate_ids=False)
    coll.update(*_batch())  # the first call's one-off work outside the profile
    tobs.TRACER.clear()
    tobs.enable(tracer_on)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        coll.update(*_batch(1))
    names = ("metrics/checks", "metrics/row_states", "metrics/scatter")
    events = [e for e in prof.events() if e.name.startswith("metrics/")]
    outer = [e for e in events if e.name == "metrics/keyed.update"]
    assert len(outer) == 1
    for name in names:
        inner = [e for e in events if e.name == name]
        # checks and row_states a bundle; one scatter, the merge of both
        assert len(inner) == (1 if name == "metrics/scatter" else 2), name
        for e in inner:
            parent = e.cpu_parent
            while parent is not None and parent is not outer[0] and parent.name != "metrics/keyed.update":
                parent = parent.cpu_parent
            assert parent is not None, name
    # the child's own range nests under row_states
    rows = [e for e in events if e.name == "metrics/row_states"][0]
    assert any(e.name.startswith("metrics/") and e.name.endswith(".update") for e in _descendants(rows))

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    (update,) = [e for e in trace if e["name"] == "metrics/keyed.update"]
    for name in names:
        for e in (e for e in trace if e["name"] == name):
            assert e["tid"] == update["tid"]
            assert update["ts"] <= e["ts"] and e["ts"] + e["dur"] <= update["ts"] + update["dur"]

    requests = tobs.TRACER.host_records()
    if tracer_on:
        assert len(requests) == 1 and requests[0].profiled and requests[0].spans == 8
    else:
        assert requests == []


def _descendants(event):
    stack, out = list(event.cpu_children), []
    while stack:
        e = stack.pop()
        out.append(e)
        stack.extend(e.cpu_children)
    return out


def test_the_host_ring_drops_the_oldest_and_counts_it():
    tracker = SpanTracker()
    tracker._host = deque(maxlen=3)
    for i in range(5):
        with tracker.span("s", i=i):
            pass
    assert [r.attrs["i"] for r in tracker.host_records()] == [2, 3, 4]
    assert [r.request for r in tracker.host_records()] == ["s|2", "s|3", "s|4"]
    host = tracker.summary()["host"]
    assert (host["size"], host["recorded"], host["dropped"], host["capacity"]) == (3, 5, 2, 3)
    tracker.clear()
    assert tracker.host_records() == [] and tracker.summary()["host"]["recorded"] == 0
    with tracker.span("s"):
        pass
    assert tracker.host_records()[0].request == "s|0"


def test_the_collective_ledger_drops_the_oldest_and_counts_it():
    tracker = SpanTracker(capacity=2)
    for bucket in "abc":
        with tracker.collective_span("gather", bucket=bucket):
            pass
    assert [s.bucket for s in tracker.records()] == ["b", "c"]
    summary = tracker.summary()
    assert (summary["size"], summary["recorded_total"], summary["dropped"]) == (2, 3, 1)
    assert summary["host"]["recorded"] == 0


def test_each_thread_has_its_own_stack():
    tracker = SpanTracker()
    barrier = threading.Barrier(2)

    def work(name):
        with tracker.span(name):
            barrier.wait(timeout=10)
            with tracker.span(name + ".inner"):
                barrier.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    requests = {r.name: r for r in tracker.host_records()}
    assert set(requests) == {"a", "b"}
    assert set(requests["a"].phases) == {"a", "a.inner"} and requests["a"].request == "a|0"
    assert set(requests["b"].phases) == {"b", "b.inner"} and requests["b"].request == "b|0"
    assert requests["a"].thread != requests["b"].thread


def _without_spans(monkeypatch):
    null = tracing._NULL_SPAN
    for module in (tmultitenant, tstacked):
        monkeypatch.setattr(module, "span", lambda *a, **k: null)
    monkeypatch.setattr(tdata, "TRACER", SpanTracker(enabled=False))


def _keyed_run():
    tobs.reset()
    coll = _collection()
    km = T.KeyedMetric(T.Accuracy(**CPU), TENANTS, **CPU)
    for seed in range(3):
        coll.update(*_batch(seed))
        km.update(*_batch(seed))
    coll.compute()
    km.compute()
    records = [(s.span_id, s.kind, s.payload) for s in tobs.TRACER.records()]
    events = tobs.EVENTS.summary()
    return records, events["by_kind"], events["recorded_total"], tobs.TRACER.summary()["recorded_total"]


def test_the_collective_ledger_and_the_events_do_not_change_with_host_spans(monkeypatch):
    with_spans = _keyed_run()
    assert tobs.TRACER.host_records()
    with monkeypatch.context() as m:
        _without_spans(m)
        without = _keyed_run()
        assert tobs.TRACER.host_records() == []
    assert with_spans == without
    assert with_spans[1]["update"] > 0 and with_spans[1]["compute"] > 0


# -- the counter stays complete ------------------------------------------------------

_HOST_ARRAY = "a numpy array already on the host: no card is waited for"

#: the reads of values written outside ``to_host``, ``(file, function, call)``,
#: and why each is not a read of the card that the counter should see
ALLOWED_READS = {
    ("utilities/data.py", "to_host", "t.tolist()"): "the helper itself",
    ("utilities/data.py", "to_host", "t.cpu().numpy()"): "the helper itself",
    ("observability/registry.py", "_drain_pending", "torch.stack([acc for _, acc in entries]).tolist()"):
        "the telemetry's own drain of its device counters",
    ("durability/checkpoint.py", "_numpy_dtype", "torch.empty(0, dtype=dtype).numpy()"):
        "a dtype probe of an empty host tensor: no values are read",
    ("durability/spill.py", "_evict_ids", "torch.empty(0, dtype=dtype).numpy()"):
        "a dtype probe of an empty host tensor: no values are read",
    ("durability/checkpoint.py", "to_host", "fn().numpy()"): "on the CPU: a host tensor",
    ("durability/checkpoint.py", "to_host", "host.numpy()"):
        "a checkpoint's copy into pinned memory, waited for by its own CUDA event off the update path",
    ("durability/spill.py", "_to_host", "src.numpy()"): "on the CPU: a host tensor",
    ("durability/spill.py", "_to_host", "host.numpy()"):
        "a cold tenant's spill into pinned memory, waited for by its own CUDA event off the update path",
    ("observability/health.py", "drain", "entry.host.numpy()"):
        "a pinned buffer whose copy's event has completed: no card is waited for",
    ("observability/health.py", "note_rows", "bool(bad.any())"): _HOST_ARRAY,
    ("observability/histogram.py", "_percentile_from", "int(counts.sum())"): _HOST_ARRAY,
    ("observability/histogram.py", "count", "int(self._counts.sum())"): _HOST_ARRAY,
    ("observability/histogram.py", "to_dict", "int(counts.sum())"): _HOST_ARRAY,
    ("observability/slo.py", "_window_stats", "float(counts.sum())"): _HOST_ARRAY,
    ("serving/queue.py", "_pop_staged_locked", "uniq.tolist()"): _HOST_ARRAY,
    ("serving/queue.py", "_pop_staged_locked", "counts.tolist()"): _HOST_ARRAY,
    ("serving/queue.py", "_stage_cohort", "int(keep.sum())"): _HOST_ARRAY,
    ("serving/queue.py", "_note_flush", "float(t_submits.min())"): _HOST_ARRAY,
    ("serving/scheduler.py", "_dispatch", "touched.tolist()"): _HOST_ARRAY,
    ("serving/staging.py", "_host_buffer", "tensor.numpy()"):
        "the numpy view of a new pinned host buffer: no values are read",
    ("wrappers/multitenant.py", "report", "int(active_mask.sum())"): _HOST_ARRAY,
    ("wrappers/multitenant.py", "report", "int(rows.sum())"): _HOST_ARRAY,
    ("wrappers/multitenant.py", "report", "float(ages.max())"): _HOST_ARRAY,
    ("wrappers/multitenant.py", "_validate_ids_eager", "int(bad_host.sum())"): _HOST_ARRAY,
}

#: tensor methods that reduce to one value, which ``int()`` and the like read
_REDUCTIONS = {"sum", "max", "min", "amax", "amin", "any", "all", "count_nonzero", "mean", "prod", "argmax",
               "argmin", "nansum", "norm"}
_HOST_MODULES = {"np", "numpy", "math"}


def _reads_a_tensor(node):
    """``node`` is a call of ``torch.*`` or a reduction method on something
    other than numpy, or an index into one."""
    if isinstance(node, ast.Subscript):
        return _reads_a_tensor(node.value)
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    owner = node.func.value
    if isinstance(owner, ast.Name) and owner.id in _HOST_MODULES:
        return False
    return (isinstance(owner, ast.Name) and owner.id == "torch") or node.func.attr in _REDUCTIONS


def _is_read(node):
    """A written read of values: ``x.tolist()``, ``x.item()``, ``x.numpy()``,
    or ``int``/``float``/``bool`` of a reduction or a ``torch`` call."""
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Attribute):
        return node.func.attr in ("tolist", "item", "numpy") and not node.args
    return (isinstance(node.func, ast.Name) and node.func.id in ("int", "float", "bool") and len(node.args) == 1
            and _reads_a_tensor(node.args[0]))


def _reads_outside_to_host(package=PACKAGE):
    """Every written read of values under ``package``: ``(file, innermost
    function, call, line)``."""
    found = []
    for path in sorted(package.rglob("*.py")):
        tree = ast.parse(path.read_text())
        owner = {}
        # ast.walk goes outside in: an inner function's nodes are claimed last
        for f in ast.walk(tree):
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)):
                owner.update((id(n), f.name) for n in ast.walk(f))
        for node in ast.walk(tree):
            if _is_read(node):
                found.append((path.relative_to(package).as_posix(), owner.get(id(node), "<module>"),
                              ast.unparse(node), node.lineno))
    return found


def test_every_host_read_goes_through_to_host():
    found = _reads_outside_to_host()
    stray = [f for f in found if f[:3] not in ALLOWED_READS]
    assert not stray, f"read tensor values with utilities/data.py::to_host, or allow the site here: {stray}"
    # every allowed site still exists, so the list cannot go stale
    assert {f[:3] for f in found} == set(ALLOWED_READS)


@pytest.mark.parametrize("read, found", [
    ("t.item()", True), ("t.tolist()", True), ("t.cpu().numpy()", True), ("int(t.sum())", True),
    ("float(torch.max(t))", True), ("bool((t == 0).any())", True), ("int(torch.nonzero(t)[0, 0])", True),
    ("int(to_host(t.sum()))", False), ("int(np.prod(t.shape))", False), ("int(t.shape[0])", False),
    ("float(x)", False),
])
def test_the_scan_finds_a_stray_read(read, found, tmp_path):
    (tmp_path / "mod.py").write_text(f"def f(t):\n    def g():\n        return {read}\n    return g\n")
    assert _reads_outside_to_host(tmp_path) == ([("mod.py", "g", read, 3)] if found else [])


# -- the eager collection update -----------------------------------------------------

COLLECTION_PHASES = {"collection.update", "checks", "shared_update", "member_update", "host_read"}


def _nine():
    """The nine-member ImageNet-style collection at ``NC`` classes."""
    macro = dict(average="macro", num_classes=NC, **CPU)
    return T.MetricCollection({
        "Accuracy": T.Accuracy(**CPU), "Precision": T.Precision(**macro), "Recall": T.Recall(**macro),
        "F1": T.F1(**macro), "Specificity": T.Specificity(**macro),
        "ConfusionMatrix": T.ConfusionMatrix(NC, **CPU), "IoU": T.IoU(NC, **CPU),
        "CohenKappa": T.CohenKappa(NC, **CPU), "MatthewsCorrcoef": T.MatthewsCorrcoef(NC, **CPU),
    })


def _two():
    """Two members, no shared-update class between them."""
    return T.MetricCollection({"Accuracy": T.Accuracy(**CPU), "ConfusionMatrix": T.ConfusionMatrix(NC, **CPU)})


# collection, members, shared members, shared-update classes, host reads an update
# (Accuracy reads the target range twice, a stat-scores class once, a
# confusion-matrix class twice: the range and the label maximum)
@pytest.mark.parametrize("build, members, shared, classes, reads", [(_nine, 9, 8, 2, 5), (_two, 2, 0, 0, 4)])
def test_an_eager_collection_update_is_one_request_with_its_phases(build, members, shared, classes, reads,
                                                                    monkeypatch):
    read_calls = Counter()
    for form in READ_FORMS:
        def counted(self, *a, _read=getattr(torch.Tensor, form), _form=form, **k):
            read_calls[_form] += 1
            return _read(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, form, counted)
    coll = build()
    for seed in range(3):
        coll.update(*_batch(seed)[1:])
    requests = tobs.TRACER.host_records()
    assert [r.request for r in requests] == [f"collection.update|{i}" for i in range(3)]
    for r in requests:
        assert set(r.phases) == COLLECTION_PHASES - ({"shared_update"} if not classes else set())
        assert r.attrs == {"path": "eager", "members": members, "shared_members": shared}
        # the request, a span a shared class, a span a member, and a checks and a host_read span a read
        assert r.spans == 1 + classes + members + 2 * reads
        assert sum(r.phases.values()) == pytest.approx(r.exit_s - r.enter_s, rel=1e-9, abs=1e-12)
        assert all(v >= 0 for v in r.phases.values())
        assert not r.profiled and r.thread == threading.get_ident()
    # every read of a value is a to_host read, counted in its request
    assert read_calls == Counter(tolist=3 * reads)
    assert [r.host_reads for r in requests] == [reads] * 3
    assert tobs.TRACER.summary()["host"]["host_reads"] == 3 * reads


def test_a_phase_is_only_ever_a_part_of_a_request():
    tracker = SpanTracker()
    null = tracing._NULL_SPAN
    assert tracker.phase("a") is null  # no request open
    with tracker.span("outer"):
        with tracker.phase("a"):
            with tracker.phase("a") as inner:  # directly inside its own name
                assert inner is null
            with tracker.phase("b"):
                pass
    (request,) = tracker.host_records()
    assert set(request.phases) == {"outer", "a", "b"} and request.spans == 3
    tracker.disable()
    with tracker.span("outer"):
        assert tracker.phase("a") is null
    assert len(tracker.host_records()) == 1


def test_nothing_is_recorded_disabled_or_inside_a_compiled_update_many():
    coll = _nine()
    _, preds, target = _batch()
    tobs.disable()
    coll.update(preds, target)
    assert tobs.TRACER.host_records() == []
    tobs.enable()
    stacked = (torch.stack([preds] * 3), torch.stack([target] * 3))
    coll.update_many(*stacked)
    assert tobs.TRACER.host_records() == []
    # inside a request of the caller's, the program's run adds no phase to it
    with tobs.TRACER.span("caller"):
        coll.update_many(*stacked)
    (request,) = tobs.TRACER.host_records()
    assert set(request.phases) == {"caller"} and request.spans == 1 and request.host_reads == 0


def test_a_keyed_update_of_the_nine_members_keeps_exactly_its_phases():
    keyed = _nine().keyed(TENANTS, validate_ids=False)
    keyed.update(*_batch())
    request = _request()
    assert set(request.phases) == {"keyed.update"} | PHASES
    # checks and row_states a bundle, one scatter for the update, and a
    # host_read a read (the Accuracy and the stat-scores bundles read their
    # target range; the confusion matrix's checks run under the vmap, which
    # reads nothing)
    assert request.attrs == {"bundles": 3, "path": "eager", "rows": ROWS}
    assert request.host_reads == 2 and request.spans == 1 + 2 * 3 + 1 + 2

