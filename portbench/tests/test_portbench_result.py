"""The result line: its five keys, the checks last, and no result without a card."""
import json
import subprocess
import sys

import pytest

from portbench.tests.helpers import ROOT, cells, run_small
from portbench import common

CELLS = cells(listed=True)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_five_keys(cell, trace, capsys, monkeypatch):
    # this test process may hold JAX (the repo's conftest loads it); the guard is tested below
    monkeypatch.setattr(common, "forbidden_modules", lambda: [])
    record = run_small(cell, seconds=0.5, trace=trace)
    record.device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 1}
    assert common.emit(record, trace) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in (record.cell.per_layer if trace else record.cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names  # every end-to-end metric of the cell, setup_s among them
    for name, c in line["checks"].items():
        assert f"check {name} " in err.strip().splitlines()[-len(line['checks']):][list(line['checks']).index(name)]


def test_no_card_no_result():
    """Without CUDA the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          str(2**31 + 1), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_jax_loaded_means_no_result(capsys, monkeypatch):
    record = common.RunRecord(cell=None)
    record.checks = {"a": (0.0, 0)}
    monkeypatch.setattr(common, "forbidden_modules", lambda: ["jax"])
    assert common.emit(record, False) != 0
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def test_checks_decide_correct():
    record = common.RunRecord(cell=None)
    record.checks = {"a": (0.0, 0), "b": (1e-7, 1e-5)}
    assert record.correct
    record.checks["b"] = (float("nan"), 1e-5)
    assert not record.correct
    record.checks = {}
    assert not record.correct
