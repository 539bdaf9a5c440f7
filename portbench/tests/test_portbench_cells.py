"""One short run of each cell on the card, through the benchmark's command.

Marked ``cuda``: each test decides, when it runs, whether the cards the cell
asks for are here, and skips otherwise. On the card's machine::

    python3 -m pytest --noconftest -m cuda portbench/tests/test_portbench_cells.py -q
"""
import json
import subprocess
import sys

import pytest

from portbench.tests.helpers import ROOT
from portbench import common

CELLS = [w["name"] for w in common.load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    chips = common.find_cell(cell).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} CUDA card(s)")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**31 + 101),
                          "--seconds", "2", "--trace", "0"], capture_output=True, text=True, cwd=str(ROOT),
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == chips
    assert "setup_s" in line["metrics"]
