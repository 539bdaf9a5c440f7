"""The port's slice as a whole: the classification ``MetricCollection``.

``MetricCollection({Accuracy, macro Precision/Recall/F1, ConfusionMatrix})``
runs ``forward`` per batch and ``compute`` at the end on both packages over
the same numpy batches; macro P/R/F1 share one ``_batch_deltas`` call per
batch; state counted under JAX continues under PyTorch after
``load_numpy_states``; and the port stands alone (no ``jax``, no
``metrics_tpu``).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as T
from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.kernels import _common
from metrics_tpu_torch.utilities.convert import load_numpy_states

ROOT = Path(__file__).resolve().parents[1]


def _batches(c, seed, n=64, count=4):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        logits = rng.rand(n, c)
        e = np.exp(logits - logits.max(1, keepdims=True))
        out.append(((e / e.sum(1, keepdims=True)).astype(np.float32), rng.randint(0, c, n)))
    return out


def _collection(pkg, c, **device):
    return pkg.MetricCollection({
        "Accuracy": pkg.Accuracy(**device),
        "Precision": pkg.Precision(average="macro", num_classes=c, **device),
        "Recall": pkg.Recall(average="macro", num_classes=c, **device),
        "F1": pkg.F1(average="macro", num_classes=c, **device),
        "ConfusionMatrix": pkg.ConfusionMatrix(num_classes=c, **device),
    }, prefix="val_")


def _assert_outputs(got, want):
    assert sorted(got) == sorted(want)
    for name, value in got.items():
        expected = np.asarray(want[name])
        if name.endswith("ConfusionMatrix"):
            assert value.dtype == torch.int32
            np.testing.assert_array_equal(value.numpy(), expected)
        else:
            assert value.dtype == torch.float32
            np.testing.assert_allclose(value.numpy(), expected, rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _zero_counters():
    _common.reset_dispatch_counters()
    yield
    _common.reset_dispatch_counters()


@pytest.mark.parametrize("c", [5, 129])
def test_collection_matches_jax(c):
    jc, tc = _collection(J, c), _collection(T, c, device="cpu")
    for preds, target in _batches(c, seed=c):
        _assert_outputs(tc(torch.from_numpy(preds), torch.from_numpy(target)),
                        jc(jnp.asarray(preds), jnp.asarray(target)))
    _assert_outputs(tc.compute(), jc.compute())
    tc.reset()
    jc.reset()
    preds, target = _batches(c, seed=c + 1, count=1)[0]
    tc.update(torch.from_numpy(preds), torch.from_numpy(target))
    jc.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_outputs(tc.compute(), jc.compute())


def test_macro_members_share_one_count_pass_per_batch(monkeypatch):
    calls = []
    original = StatScores._batch_deltas

    def counting(self, *args, **kwargs):
        calls.append(type(self).__name__)
        return original(self, *args, **kwargs)

    monkeypatch.setattr(StatScores, "_batch_deltas", counting)
    tc = _collection(T, 5, device="cpu")
    batches = _batches(5, seed=3)
    for preds, target in batches:
        tc(torch.from_numpy(preds), torch.from_numpy(target))
    tc.update(torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    assert len(calls) == len(batches) + 1
    # one stat-scores count pass and one confusion-matrix count pass per batch
    assert _common.dispatch_count("stat_scores_counts", "torch") == len(batches) + 1
    assert _common.dispatch_count("confmat_counts", "torch") == len(batches) + 1


def test_state_carried_across_from_jax_mid_stream():
    c, k = 129, 2
    batches = _batches(c, seed=11, count=5)
    jc, tc = _collection(J, c), _collection(T, c, device="cpu")
    for preds, target in batches[:k]:
        jc(jnp.asarray(preds), jnp.asarray(target))
    states = {name: {s: np.asarray(v) if not isinstance(v, list) else [np.asarray(x) for x in v]
                     for s, v in m._get_states().items()}
              for name, m in jc.items(keep_base=True)}
    load_numpy_states(tc, states)
    assert tc["Precision"].tp.dtype == torch.int32 and tc["ConfusionMatrix"].confmat.dtype == torch.int32
    _assert_outputs(tc.compute(), jc.compute())
    for preds, target in batches[k:]:
        _assert_outputs(tc(torch.from_numpy(preds), torch.from_numpy(target)),
                        jc(jnp.asarray(preds), jnp.asarray(target)))
    _assert_outputs(tc.compute(), jc.compute())


def test_load_numpy_states_rejects_mismatched_states():
    m = T.ConfusionMatrix(num_classes=3, device="cpu")
    with pytest.raises(KeyError):
        load_numpy_states(m, {"wrong": np.zeros((3, 3))})
    with pytest.raises(ValueError):
        load_numpy_states(m, {"confmat": np.zeros((4, 4))})
    with pytest.raises(ValueError):
        load_numpy_states(m, {"confmat": np.zeros((3, 3))}, device="meta")


def test_collection_naming_clone_and_state_dict():
    tc = _collection(T, 3, device="cpu")
    assert list(tc.keys()) == [f"val_{n}" for n in ("Accuracy", "ConfusionMatrix", "F1", "Precision", "Recall")]
    preds, target = _batches(3, seed=1, count=1)[0]
    tc(torch.from_numpy(preds), torch.from_numpy(target))
    twin = tc.clone(prefix="test_")
    assert "test_F1" in twin.compute()
    tc.persistent(True)
    sd = tc.state_dict()
    assert torch.equal(sd["ConfusionMatrix.confmat"], tc["ConfusionMatrix"].confmat)
    fresh = _collection(T, 3, device="cpu")
    fresh.load_state_dict(sd)
    with pytest.warns(UserWarning, match="before the ``update``"):  # as in the JAX package
        _assert_outputs(fresh.compute(), {k: v.numpy() for k, v in tc.compute().items()})
    with pytest.raises(ValueError, match="keeps its states on cpu"):
        tc(torch.empty(4, 3, device="meta"), torch.empty(4, dtype=torch.long, device="meta"))


def test_port_imports_neither_jax_nor_metrics_tpu():
    code = (
        "import sys, metrics_tpu_torch, metrics_tpu_torch.functional, metrics_tpu_torch.utilities.convert\n"
        "import metrics_tpu_torch.wrappers, metrics_tpu_torch.utilities.stacked, metrics_tpu_torch.kernels.segment_scatter\n"
        "import metrics_tpu_torch.kernels.binned_counts, metrics_tpu_torch.kernels.sketches\n"
        "import metrics_tpu_torch.utilities.sketching, metrics_tpu_torch.classification.binned_precision_recall\n"
        "import metrics_tpu_torch.transport, metrics_tpu_torch.utilities.distributed\n"
        "import metrics_tpu_torch.observability, metrics_tpu_torch.observability.export, metrics_tpu_torch.average\n"
        "import metrics_tpu_torch.classification.hinge, metrics_tpu_torch.classification.kldivergence\n"
        "import metrics_tpu_torch.classification.hamming_distance, metrics_tpu_torch.functional.classification.dice\n"
        "import metrics_tpu_torch.regression, metrics_tpu_torch.image, metrics_tpu_torch.functional.regression\n"
        "import metrics_tpu_torch.retrieval, metrics_tpu_torch.functional.retrieval\n"
        "bad = [m for m in sys.modules if m in ('jax', 'metrics_tpu') or m.startswith(('jax.', 'metrics_tpu.'))]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_metrics_tpu():
    files = sorted((ROOT / "metrics_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests/test_torch_card.py"]
    assert len(files) > 10
    for new in ("wrappers/__init__.py", "wrappers/multitenant.py", "utilities/stacked.py", "kernels/segment_scatter.py",
                "kernels/binned_counts.py", "kernels/sketches.py", "utilities/sketching.py", "classification/auroc.py",
                "functional/classification/precision_recall_curve.py", "transport/__init__.py", "transport/base.py",
                "transport/gather.py", "transport/loopback.py", "utilities/distributed.py", "classification/iou.py",
                "classification/cohen_kappa.py", "classification/matthews_corrcoef.py", "classification/specificity.py",
                "functional/classification/iou.py", "functional/classification/cohen_kappa.py",
                "functional/classification/matthews_corrcoef.py", "functional/classification/specificity.py",
                "observability/__init__.py", "observability/histogram.py", "observability/registry.py",
                "observability/events.py", "observability/tracing.py", "observability/export.py", "average.py",
                "classification/hamming_distance.py", "classification/hinge.py", "classification/kldivergence.py",
                "functional/classification/hamming_distance.py", "functional/classification/dice.py",
                "functional/classification/hinge.py", "functional/classification/kldivergence.py",
                "regression/__init__.py", "regression/mean_squared_error.py", "regression/mean_absolute_error.py",
                "regression/mean_absolute_percentage_error.py", "regression/mean_squared_log_error.py",
                "regression/explained_variance.py", "regression/r2score.py", "regression/cosine_similarity.py",
                "regression/pearson.py", "regression/spearman.py", "regression/psnr.py", "regression/ssim.py",
                "image/__init__.py", "image/psnr.py", "image/ssim.py", "functional/regression/__init__.py",
                "functional/regression/mean_squared_error.py", "functional/regression/mean_absolute_error.py",
                "functional/regression/mean_absolute_percentage_error.py",
                "functional/regression/mean_relative_error.py", "functional/regression/mean_squared_log_error.py",
                "functional/regression/explained_variance.py", "functional/regression/r2score.py",
                "functional/regression/cosine_similarity.py", "functional/regression/pearson.py",
                "functional/regression/spearman.py", "functional/regression/psnr.py",
                "functional/regression/ssim.py", "retrieval/__init__.py", "retrieval/retrieval_metric.py",
                "retrieval/mean_average_precision.py", "retrieval/mean_reciprocal_rank.py",
                "retrieval/retrieval_precision.py", "retrieval/retrieval_recall.py", "retrieval/retrieval_fallout.py",
                "retrieval/retrieval_ndcg.py", "functional/retrieval/__init__.py", "functional/retrieval/precision.py",
                "functional/retrieval/average_precision.py", "functional/retrieval/reciprocal_rank.py",
                "functional/retrieval/recall.py", "functional/retrieval/fall_out.py", "functional/retrieval/ndcg.py"):
        assert ROOT / "metrics_tpu_torch" / new in files
    for path in files:
        for name in _imported_modules(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "metrics_tpu"), f"{path.relative_to(ROOT)} imports {name}"
