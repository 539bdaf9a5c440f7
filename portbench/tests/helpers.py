"""Small cells for the CPU tests: every configuration cut to a size a test
run can hold, found by its name as a run finds it."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402

SMALL = {
    "keyed_tenants": dict(num_tenants=50, cohort_rows=256, cohorts=5, last_cohort_real_rows=100),
}


def cells(driver=None, listed=False):
    """The cells whose traffic files are here (with ``listed``, those of
    ``BENCHMARK.json`` alone), of one driver where one is named."""
    names = {w["name"] for w in common.load_json(ROOT / "BENCHMARK.json")["workloads"]}
    out = []
    for path in sorted((common.HERE / "traffic").glob("*.json")):
        name = path.name[: -len(".json")]
        if (listed and name not in names) or (driver and common.load_json(path)["driver"] != driver):
            continue
        out.append(name)
    return out


def find(name):
    """The cell ``name`` as a run finds it, or, for a cell whose files are here
    but which ``BENCHMARK.json`` does not list, built from its files alone."""
    bench = common.load_json(ROOT / "BENCHMARK.json")
    if name not in {w["name"] for w in bench["workloads"]}:
        config = name.rsplit(".", 1)[0]
        bench = dict(bench, workloads=[{"name": name, "config": config, "traffic": name.rsplit(".", 1)[1],
                                        "chips": 1, "why": "-"}],
                     configs=[{"name": config, "file": f"portbench/configs/{config}.json"}])
    return common.find_cell(name, bench)


def small_cell(name):
    """The cell ``name`` of ``BENCHMARK.json`` at a size a CPU test can hold."""
    cell = find(name)
    cell.cfg.update(SMALL[cell.config_name])
    return cell


def run_small(name, seed=2**31 + 17, seconds=1.0, trace=False, **kw):
    cell = small_cell(name)
    return cell.driver().run(cell, seed=seed, seconds=seconds, trace=trace, t_start=time.time(), device="cpu", **kw)
