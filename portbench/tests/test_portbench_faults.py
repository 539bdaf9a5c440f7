"""The check at work: a run driven on the CPU at a small size, with the
harness's look for a card skipped, must come out not correct when the timed
path is broken underneath (once for each fault the cell can have), and when
the control (the reference computed in bfloat16) is put in the program's
place; and correct when nothing is broken."""
import pytest

import metrics_tpu_torch as M
from portbench.tests.helpers import ROOT, cells, run_small, small_cell
from portbench import common

CELLS = cells()


def _half(update):
    def half(self, *args, **kw):
        n = args[0].shape[0]
        return update(self, *(a[: n // 2] for a in args), **kw)
    return half


def _unchanged(update):
    """Every update after the first returns the state as it found it (the
    first builds the keyed bundles, which a keyed compute needs)."""
    calls = []

    def unchanged(self, *args, **kw):
        calls.append(1)
        if len(calls) == 1:
            return update(self, *args, **kw)
    return unchanged


def _altered(compute):
    def altered(self, *args, **kw):
        out = dict(compute(self, *args, **kw))
        k = "Accuracy"
        out[k] = out[k] + 1e-3
        return out
    return altered


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert run_small(cell).correct


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    owner = M.MultiTenantCollection
    if fault == "state_unchanged":
        monkeypatch.setattr(owner, "update", _unchanged(owner.update))
    elif fault == "half_batch":
        monkeypatch.setattr(owner, "update", _half(owner.update))
    else:
        monkeypatch.setattr(owner, "compute", _altered(owner.compute))
    record = run_small(cell)
    assert not record.correct, record.checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference computed in bfloat16 in the program's place fails the check."""
    calibrate = common.load_module(ROOT / "portbench" / "calibrate.py", "portbench_calibrate")
    c = small_cell(cell)
    checks = calibrate.control_checks(c, 2**31 + 29, "cpu")
    assert any(v > limit for v, limit in checks.values()), checks
