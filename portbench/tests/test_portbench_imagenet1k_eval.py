"""The ``imagenet1k_eval.update`` cell on the CPU at a small size (37
classes, 168 rows in batches of 64): its reference against hand-computed
cases, its check at work (correct when nothing is broken, not correct under
each fault and for the bfloat16 control), its result line, a run that loads
no JAX, and the six per-layer metrics read from the program's
``collection.update`` requests (``portbench/collection_spans.py``)."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import metrics_tpu_torch as M
from portbench import collection_spans, common
from portbench.tests import helpers
from portbench.tests.helpers import ROOT

CELL = "imagenet1k_eval.update"
SMALL = dict(num_classes=37, num_samples=168, batch_size=64)
REF = common.load_module(common.HERE / "reference" / "imagenet1k_eval.py", "portbench_reference_imagenet1k_eval")
CONFIG = common.load_module(common.HERE / "configs" / "imagenet1k_eval.py", "portbench_config_imagenet1k_eval")
TIMES = ("collection_checks_ms", "collection_shared_ms", "collection_members_ms", "collection_host_read_ms")
COUNTS = ("collection_host_reads_per_update", "collection_shared_members_per_update")


def _cell():
    cell = common.find_cell(CELL)
    cell.cfg.update(SMALL)
    return cell


def _run(seconds=0.5, trace=False, seed=2**31 + 17):
    cell = _cell()
    return cell.driver().run(cell, seed=seed, seconds=seconds, trace=trace, t_start=0.0, device="cpu")


@pytest.fixture()
def tracer():
    from metrics_tpu_torch import observability

    observability.reset()
    yield observability.TRACER
    observability.reset()
    observability.enable()


# -- the reference -------------------------------------------------------------------


def test_argmax_takes_the_first_largest_and_rows_are_targets():
    scores = torch.tensor([[0.4, 0.4, 0.2], [0.1, 0.2, 0.7], [0.3, 0.6, 0.1]])
    pred = REF.predicted(torch, scores, torch.float64)
    assert pred.tolist() == [0, 2, 1]
    cm = REF.confmat(pred, np.array([0, 2, 0]), 3)
    assert cm.tolist() == [[1, 1, 0], [0, 0, 0], [0, 0, 1]] and cm.dtype == np.int64


def test_values_by_hand_with_an_absent_class():
    # class 2 is in neither the targets nor the predictions
    cm = np.array([[2, 1, 0], [0, 1, 0], [0, 0, 0]], np.int64)
    got = REF.values(torch, cm, torch.float64)
    want = {
        "Accuracy": 3 / 4,
        "Precision": (1 + 1 / 2 + 0) / 3,
        "Recall": (2 / 3 + 1 + 0) / 3,
        "F1": (0.8 + 2 / 3 + 0) / 3,
        "Specificity": (1 + 2 / 3 + 1) / 3,
        "IoU": (2 / 3 + 1 / 2 + 0) / 3,
        "CohenKappa": 1 - 1 / 2,
        "MatthewsCorrcoef": 4 / np.sqrt((16 - 8) * (16 - 10)),
    }
    for name, value in want.items():
        assert got[name].item() == pytest.approx(value, rel=1e-12), name
    assert got["ConfusionMatrix"].tolist() == cm.tolist()


def test_state_off_counts_a_missing_or_reshaped_matrix_whole():
    want = np.zeros((3, 3), np.int64)
    assert REF.state_off(None, want) == 9
    assert REF.state_off(torch.zeros(2, 2, dtype=torch.int32), want) == 9
    assert REF.state_off(torch.eye(3, dtype=torch.int32), want) == 3


# -- the check at work ---------------------------------------------------------------


def test_sound_run_is_correct():
    record = _run()
    assert record.correct, record.checks
    assert record.checks["state_off"][0] == 0


def _unchanged(update):
    calls = []

    def unchanged(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            update(self, *args, **kwargs)
    return unchanged


def _half(update):
    def half(self, preds, target):
        update(self, preds[: len(preds) // 2], target[: len(target) // 2])
    return half


def _altered(compute):
    def altered(self):
        out = dict(compute(self))
        out["Accuracy"] = out["Accuracy"] + 1e-3
        return out
    return altered


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    owner = M.MetricCollection
    if fault == "answer_altered":
        monkeypatch.setattr(owner, "compute", _altered(owner.compute))
    else:
        monkeypatch.setattr(owner, "update", (_unchanged if fault == "state_unchanged" else _half)(owner.update))
    record = _run()
    assert not record.correct, record.checks


def test_control_is_not_correct():
    cell = _cell()
    batches = CONFIG.inputs(torch, cell.cfg, 2**31 + 29, torch.device("cpu"))
    preds = torch.cat([b[0] for b in batches])
    target = torch.cat([b[1] for b in batches]).numpy()
    values, end_state = REF.control(torch, cell.cfg, preds, target)
    checks = REF.check(torch, cell.cfg, preds, target, [values], end_state)
    assert any(v > limit for v, limit in checks.values()), checks


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_five_keys(trace, capsys, monkeypatch):
    monkeypatch.setattr(common, "forbidden_modules", lambda: [])  # this process may hold JAX
    record = _run(trace=trace)
    record.device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 1}
    assert common.emit(record, trace) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] == record.attempted > 0
    if trace:
        assert set(TIMES + COUNTS) <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"rows_per_s", "setup_s"}


PROBE = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
from pathlib import Path
root = Path(sys.argv[1]) / "portbench"
for i, path in enumerate(sorted(root.rglob("*.py"))):
    if "tests" in path.parts:
        continue
    spec = importlib.util.spec_from_file_location(f"probe_{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from portbench import common
from portbench.tests.helpers import cells, find
small = json.loads(sys.argv[2])
for name in cells():
    cell = find(name)
    cell.cfg.update(small[cell.config_name])
    record = cell.driver().run(cell, seed=2**31 + 5, seconds=0.3, trace=True, t_start=0.0, device="cpu")
    assert record.correct, (name, record.checks)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_run_of_any_cell_loads_jax():
    """``test_portbench_isolation.py``'s probe with this configuration's
    small size beside ``helpers.SMALL``'s: every benchmark module imported
    and every cell driven, traced, in a fresh interpreter."""
    small = {**helpers.SMALL, "imagenet1k_eval": SMALL}
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT), json.dumps(small)], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT),
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "metrics_tpu_torch" in loaded
    assert not loaded & set(common.FORBIDDEN_MODULES)


# -- the six per-layer metrics -------------------------------------------------------


def _requests(tracer, profiled):
    return [r for r in tracer.host_records() if r.name == "collection.update" and r.profiled is profiled]


def test_the_six_metrics_split_the_collection_update(tracer):
    record = _run(trace=True)
    metrics = common.read_layers(record)
    assert set(TIMES + COUNTS) <= set(metrics)
    window = collection_spans.requests(record)
    mean_update_ms = 1e3 * sum(r.exit_s - r.enter_s for r in window) / len(window)
    rest_ms = collection_spans.read_ms(record, "rest")
    assert sum(metrics[name]["value"] for name in TIMES) + rest_ms == pytest.approx(mean_update_ms, rel=1e-9)
    assert all(metrics[name]["value"] >= 0 for name in TIMES) and rest_ms >= 0
    assert metrics["collection_host_reads_per_update"] == {"value": 5.0, "unit": "reads"}
    assert metrics["collection_shared_members_per_update"] == {"value": 8.0, "unit": "members"}

    # the window: its N updates, after the warm epoch's and before the profiled epochs'
    n = len(record.spans["update"])
    per_epoch = -(-SMALL["num_samples"] // SMALL["batch_size"])
    unprofiled, profiled = _requests(tracer, False), _requests(tracer, True)
    assert len(window) == n and len(unprofiled) == per_epoch + n
    assert [r.request for r in window] == [r.request for r in unprofiled[per_epoch:]]
    assert len(profiled) == record.cell.traffic["profile_epochs"] * per_epoch
    assert window[-1].exit_s < profiled[0].enter_s
    assert 1e3 * sum(record.spans["update"]) / n >= mean_update_ms


def _reader(name):
    return common.load_module(common.HERE / "layers" / f"{name}.py", f"probe_{name}")


def test_nothing_to_read_gives_no_metric(tracer, monkeypatch):
    record = _run(seconds=0.3, trace=True)
    older = [r._replace(attrs={k: v for k, v in r.attrs.items() if k != "shared_members"})
             for r in collection_spans.requests(record)]
    with monkeypatch.context() as m:
        m.setattr(collection_spans, "requests", lambda _: older)  # requests without the attr
        assert _reader("collection_shared_members_per_update").read(record) is None
        assert _reader("collection_checks_ms").read(record) is not None
    # a program without host requests, or whose collection update opens none, as the parent commit's
    monkeypatch.setattr(collection_spans, "_tracer", lambda: None)
    assert all(_reader(name).read(record) is None for name in TIMES + COUNTS)
    monkeypatch.undo()
    tracer.clear()
    assert all(_reader(name).read(record) is None for name in TIMES + COUNTS)
