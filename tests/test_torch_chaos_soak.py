"""The chaos soak on the CPU, a short window.

Counterpart of ``tests/resilience/test_chaos_soak.py``. The port's chaos run
is ``chip_smoke.py``'s phase 3o-d (``chaos_fleet`` and ``chaos_window``),
which runs 10 s at 8,000 rows/s on the card; here the same code runs on the
CPU for 1.5 s at 2,000 rows/s over 256 tenants. The fleet phase (a 3-rank
world of threads over ``StoreSubgroupChannel``s and one ``TCPStore``, rank 2
dead) is held against the JAX package's ``scripts/soak.py::run_chaos_fleet``
on the same seed: the same faults fire at the same seam hits and the
membership epoch moves the same way.
"""
import importlib.util
import os
import sys

import pytest
import torch

import metrics_tpu_torch as T

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke_for_tests", os.path.join(_ROOT, "chip_smoke.py"))


@pytest.fixture(autouse=True)
def _clean():
    import metrics_tpu_torch.resilience as res

    res.reset()
    yield
    res.reset()


def test_the_fleet_phase_equals_the_jax_package_on_its_seed(smoke):
    sys.path.insert(0, os.path.join(_ROOT, "scripts"))
    try:
        import metrics_tpu.resilience as jres
        soak = _load("soak_for_tests", os.path.join(_ROOT, "scripts", "soak.py"))
        jres.reset()
        want = soak.run_chaos_fleet(1234)
        jres.reset()
    finally:
        sys.path.remove(os.path.join(_ROOT, "scripts"))
    got = smoke.chaos_fleet(torch, "cpu", seed=1234)
    assert got["ok"], got
    for key in ("payload_drop_recovered", "round_counter_consistent", "hung_get_absorbed", "epoch_final",
                "epoch_transitions"):
        assert got[key] == want[key], key
    assert got["faults"]["fired_by_seam"] == want["faults"]["fired_by_seam"]
    assert got["faults"]["fired"] == want["faults"]["fired"] == 2
    assert got["failover_mttr_ms"] < 5000.0


def test_a_short_chaos_window_keeps_every_invariant(smoke):
    out = smoke.chaos_window(torch, T, "cpu", seconds=1.5, qps=2000, tenants=256, max_batch=128)
    assert out["ok"], (out["invariants"], out["errors"])
    assert out["submitted"] - sum(out["shed_by_reason"].values()) == out["dispatched"] == out["rows_routed"]
    assert out["shed_by_reason"]["dispatch_error"] > 0 and out["poisoned"]["quarantined"] >= 1
    assert out["checkpoint"]["save_errors"] >= 1 and out["checkpoint"]["restore_bit_identical"]
    assert out["faults"]["fired_by_seam"] == {"serving.dispatch:error": 2, "checkpoint.before_manifest:error": 1}
