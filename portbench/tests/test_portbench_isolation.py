"""Nothing the benchmark loads is JAX or the JAX package, and the references
import nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.tests.helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "metrics_tpu"}
HERE = ROOT / "portbench"

PROBE = r"""
import importlib.util, json, sys, time
sys.path.insert(0, sys.argv[1])
from pathlib import Path
root = Path(sys.argv[1]) / "portbench"
for i, path in enumerate(sorted(root.rglob("*.py"))):
    if "tests" in path.parts:
        continue
    spec = importlib.util.spec_from_file_location(f"probe_{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
sys.path.insert(0, str(root / "tests"))
from portbench.tests.helpers import cells, run_small
for cell in cells():
    run_small(cell, seconds=0.3)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_run_loads_jax_or_the_jax_package():
    """Every benchmark module imported, and each cell driven at a
    small size on the CPU, in a fresh interpreter: no loaded module's
    top-level name, compared whole, is forbidden (``metrics_tpu_torch`` is
    the port and is allowed)."""
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT), env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "metrics_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in ("import_module", "__import__"):
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def test_references_import_nothing_of_the_program():
    files = sorted((HERE / "reference").glob("*.py"))
    assert files
    for path in files:
        names = {n.split(".")[0] for n in _imports(path)}
        assert not names & (FORBIDDEN | {"metrics_tpu_torch"}), (path.name, names)
        assert "metrics_tpu" not in path.read_text(), path.name


def test_every_named_file_exists():
    """Each configuration, traffic mix, per-layer metric, driver and
    reference that BENCHMARK.json names is a file of its own, found by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert (HERE / "configs" / f"{c['name']}.py").is_file()
        assert (HERE / "reference" / f"{c['name']}.py").is_file()
    for w in bench["workloads"]:
        traffic = json.loads((HERE / "traffic" / f"{w['name']}.json").read_text())
        assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    for m in bench["per_layer"]:
        assert (HERE / "layers" / f"{m['name']}.py").is_file()
