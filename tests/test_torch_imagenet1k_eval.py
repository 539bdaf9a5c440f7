"""The ImageNet-1k evaluation loop's plain reference
(``portbench/reference/imagenet1k_eval.py``, loaded by path) against the
port's nine-member ``MetricCollection`` and the JAX package, on the CPU at a
small size.

37 classes in batches of 64, 64 and 40 rows: class 36 is absent from both
the predictions and the targets, and a quarter of the rows hold their
largest score twice (the first one is the prediction). The collection runs
two epochs, each ended as a validation loop ends it (``compute()`` to the
host, ``reset()``), and the reference's check passes on both; it refuses a
state left unchanged, half a batch left out and one altered value, and the
reference itself computed in bfloat16 (the control).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as T

ROOT = Path(__file__).resolve().parents[1]
C, ROWS, ABSENT = 37, (64, 64, 40), 36
CFG = {"num_classes": C, "average": "macro"}


def _load(kind):
    path = ROOT / "portbench" / kind / "imagenet1k_eval.py"
    spec = importlib.util.spec_from_file_location(f"imagenet1k_eval_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF, CONFIG = _load("reference"), _load("configs")


def _batches(seed):
    g = torch.Generator().manual_seed(seed)
    n = sum(ROWS)
    target = torch.randint(0, C - 1, (n,), generator=g)
    logits = torch.randn(n, C, generator=g)
    logits[torch.arange(n), target] += 2.0
    logits[:, ABSENT] = -30.0
    tied = torch.arange(0, n, 4)
    top = logits[tied].argmax(dim=1)
    logits[tied, (top + 5) % (C - 1)] = logits[tied, top]
    preds = torch.softmax(logits, dim=1)
    bounds = np.cumsum((0,) + ROWS)
    return [(preds[a:b], target[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def _epochs(batches, epochs=2):
    """The loop as the benchmark runs it: ``epochs`` of one update a batch,
    each ended by ``end_epoch``; the kept values and the matrix left after."""
    coll = CONFIG.build(T, CFG, "cpu")
    kept = []
    for _ in range(epochs):
        for batch in batches:
            CONFIG.update(coll, batch)
        kept.append(CONFIG.end_epoch(coll))
    return kept, CONFIG.end_state(coll)


def _whole(batches):
    return torch.cat([b[0] for b in batches]), torch.cat([b[1] for b in batches]).numpy()


@pytest.mark.parametrize("seed", [2**31 + 3, 2**31 + 4])
def test_the_collection_matches_the_reference_epoch_after_epoch(seed):
    batches = _batches(seed)
    preds, target = _whole(batches)
    pred = REF.predicted(torch, preds, torch.float64)
    assert ABSENT not in set(target.tolist()) | set(pred.tolist())
    top = preds.max(dim=1, keepdim=True).values
    assert int(((preds == top).sum(dim=1) > 1).sum()) >= len(target) // 4  # ties, first largest taken
    kept, end_state = _epochs(batches)
    checks = REF.check(torch, CFG, preds, target, kept, end_state)
    assert all(value <= limit for value, limit in checks.values()), checks
    want = REF.values(torch, REF.confmat(pred, target, C), torch.float64)
    for values in kept:
        assert torch.equal(values["ConfusionMatrix"].to(torch.int64), want["ConfusionMatrix"])
        assert set(values) == set(want)


def test_the_reference_follows_the_jax_package():
    """The reference's values, with the absent class and the ties, against
    the JAX package's collection on the same rows (float32 there)."""
    preds, target = _whole(_batches(2**31 + 5))
    macro = dict(average="macro", num_classes=C)
    jax_coll = J.MetricCollection({
        "Accuracy": J.Accuracy(), "Precision": J.Precision(**macro), "Recall": J.Recall(**macro),
        "F1": J.F1(**macro), "Specificity": J.Specificity(**macro), "ConfusionMatrix": J.ConfusionMatrix(C),
        "IoU": J.IoU(C), "CohenKappa": J.CohenKappa(C), "MatthewsCorrcoef": J.MatthewsCorrcoef(C),
    })
    jax_coll.update(jnp.asarray(preds.numpy()), jnp.asarray(target))
    got = {k: torch.from_numpy(np.asarray(v)) for k, v in jax_coll.compute().items()}
    want = REF.values(torch, REF.confmat(REF.predicted(torch, preds, torch.float64), target, C), torch.float64)
    assert REF.values_gap(torch, got, want) < REF.LIMITS["values_gap"]
    assert REF.state_off(got["ConfusionMatrix"], want["ConfusionMatrix"].numpy()) == 0


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
        out["CohenKappa"] = out["CohenKappa"] + 1e-4
        return out
    return altered


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "one_value_altered"])
def test_the_check_refuses_a_fault(fault, monkeypatch):
    batches = _batches(2**31 + 6)
    owner = T.MetricCollection
    if fault == "one_value_altered":
        monkeypatch.setattr(owner, "compute", _altered(owner.compute))
    else:
        monkeypatch.setattr(owner, "update", (_unchanged if fault == "state_unchanged" else _half)(owner.update))
    kept, end_state = _epochs(batches)
    checks = REF.check(torch, CFG, *_whole(batches), kept, end_state)
    assert any(value > limit for value, limit in checks.values()), checks


def test_the_bfloat16_control_is_refused():
    preds, target = _whole(_batches(2**31 + 7))
    values, end_state = REF.control(torch, CFG, preds, target)
    checks = REF.check(torch, CFG, preds, target, [values], end_state)
    assert any(value > limit for value, limit in checks.values()), checks
