"""The port's stat-scores family and confusion matrix against the JAX package's.

Functional and module ``StatScores``/``Accuracy``/``Precision``/``Recall``/
``FBeta``/``F1``/``ConfusionMatrix`` get the same numpy batches on both
sides, across ``average`` in {micro, macro, weighted, none}, ``ignore_index``
and ``normalize``; the module metrics run ``forward`` on every batch and
``compute`` at the end. Counts and confusion matrices must be exact; the
float scores are float32 on both sides and agree within ``rtol=1e-6,
atol=1e-7`` (the sums run in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as JF
import metrics_tpu_torch as T
import metrics_tpu_torch.functional as TF


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _inputs(kind, c, seed, n=48, batches=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        if kind == "mc_prob":
            out.append((_softmax(rng.rand(n, c), 1), rng.randint(0, c, n)))
        elif kind == "mc":
            out.append((rng.randint(0, c, n), rng.randint(0, c, n)))
        elif kind == "ml_prob":
            out.append((rng.rand(n, c).astype(np.float32), rng.randint(0, 2, (n, c))))
        elif kind == "mdmc_prob":
            out.append((_softmax(rng.rand(n, c, 3), 1), rng.randint(0, c, (n, 3))))
        elif kind == "bin_prob":
            out.append((rng.rand(n).astype(np.float32), rng.randint(0, 2, n)))
    return out


def _assert_same(got, want, exact=False):
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor)
    if exact or not np.issubdtype(want.dtype, np.floating):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7, equal_nan=True)


CASES = [
    ("mc_prob", 5, {}),
    ("mc_prob", 129, {}),
    ("mc", 3, {}),
    ("ml_prob", 5, {}),
    ("mdmc_prob", 3, {"mdmc_average": "global"}),
    ("mc_prob", 5, {"ignore_index": 1}),
    ("mc_prob", 600, {}),
]
AVERAGES = ["micro", "macro", "weighted", "none"]
METRICS = [
    ("Accuracy", "accuracy", {}),
    ("Precision", "precision", {}),
    ("Recall", "recall", {}),
    ("F1", "f1", {}),
    ("FBeta", "fbeta", {"beta": 0.5}),
]


def _case_id(case):
    kind, c, extra = case
    return f"{kind}-C{c}" + "".join(f"-{k}={v}" for k, v in extra.items())


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("cls_name, fn_name, extra_kwargs", METRICS, ids=[m[0] for m in METRICS])
def test_module_and_functional_match_jax(cls_name, fn_name, extra_kwargs, average, case):
    kind, c, case_kwargs = case
    kwargs = dict(average=average, num_classes=c, **case_kwargs, **extra_kwargs)
    jm = getattr(J, cls_name)(**kwargs)
    tm = getattr(T, cls_name)(device="cpu", **kwargs)
    for batch_idx, (preds, target) in enumerate(_inputs(kind, c, seed=c * 10 + len(kind))):
        tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
        jp, jt = jnp.asarray(preds), jnp.asarray(target)
        _assert_same(tm(tp, tt), jm(jp, jt))
        if batch_idx == 0:
            _assert_same(getattr(TF, fn_name)(tp, tt, **kwargs), getattr(JF, fn_name)(jp, jt, **kwargs))
    _assert_same(tm.compute(), jm.compute())


@pytest.mark.parametrize("kind, c", [("mc_prob", 5), ("mc_prob", 600), ("mc", 3), ("ml_prob", 5),
                                     ("bin_prob", 1), ("mdmc_prob", 3)])
@pytest.mark.parametrize("reduce", ["micro", "macro", "samples"])
def test_stat_scores_match_jax(kind, c, reduce):
    kwargs = dict(reduce=reduce, num_classes=c if reduce == "macro" else None)
    if kind == "mdmc_prob":
        kwargs["mdmc_reduce"] = "global"
    jm, tm = J.StatScores(**kwargs), T.StatScores(device="cpu", **kwargs)
    for preds, target in _inputs(kind, c, seed=c + 3):
        tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
        jp, jt = jnp.asarray(preds), jnp.asarray(target)
        _assert_same(tm(tp, tt), jm(jp, jt), exact=True)
        _assert_same(TF.stat_scores(tp, tt, **kwargs), JF.stat_scores(jp, jt, **kwargs), exact=True)
    _assert_same(tm.compute(), jm.compute(), exact=True)


@pytest.mark.parametrize("mdmc_reduce", ["global", "samplewise"])
def test_multidim_stat_scores_match_jax(mdmc_reduce):
    kwargs = dict(reduce="macro", num_classes=3, mdmc_reduce=mdmc_reduce, ignore_index=0)
    jm, tm = J.StatScores(**kwargs), T.StatScores(device="cpu", **kwargs)
    for preds, target in _inputs("mdmc_prob", 3, seed=11):
        tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
        _assert_same(tm(tp, tt), jm(jnp.asarray(preds), jnp.asarray(target)), exact=True)
    _assert_same(tm.compute(), jm.compute(), exact=True)


@pytest.mark.parametrize("average", ["macro", "none"])
def test_samplewise_precision_matches_jax(average):
    kwargs = dict(average=average, num_classes=3, mdmc_average="samplewise")
    jm, tm = J.Precision(**kwargs), T.Precision(device="cpu", **kwargs)
    for preds, target in _inputs("mdmc_prob", 3, seed=5):
        _assert_same(tm(torch.from_numpy(preds), torch.from_numpy(target)),
                     jm(jnp.asarray(preds), jnp.asarray(target)))
    _assert_same(tm.compute(), jm.compute())


@pytest.mark.parametrize("top_k", [1, 2])
def test_top_k_and_subset_accuracy_match_jax(top_k):
    jm, tm = J.Accuracy(top_k=top_k), T.Accuracy(top_k=top_k, device="cpu")
    js, ts = J.Accuracy(subset_accuracy=True), T.Accuracy(subset_accuracy=True, device="cpu")
    for (preds, target), (ml_preds, ml_target) in zip(_inputs("mc_prob", 5, seed=9), _inputs("ml_prob", 5, seed=9)):
        _assert_same(tm(torch.from_numpy(preds), torch.from_numpy(target)), jm(jnp.asarray(preds), jnp.asarray(target)))
        _assert_same(ts(torch.from_numpy(ml_preds), torch.from_numpy(ml_target)),
                     js(jnp.asarray(ml_preds), jnp.asarray(ml_target)))
    _assert_same(tm.compute(), jm.compute())
    _assert_same(ts.compute(), js.compute())
    assert ts.correct.dtype == torch.int32 and ts.total.dtype == torch.int32


@pytest.mark.filterwarnings("ignore:.*nan values found in confusion matrix")
@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
@pytest.mark.parametrize("kind, c", [("mc_prob", 3), ("mc_prob", 129), ("mc", 5), ("bin_prob", 2),
                                     ("mdmc_prob", 3), ("mc_prob", 600)])
def test_confusion_matrix_matches_jax(kind, c, normalize):
    jm = J.ConfusionMatrix(num_classes=c, normalize=normalize)
    tm = T.ConfusionMatrix(num_classes=c, normalize=normalize, device="cpu")
    exact = normalize is None
    for preds, target in _inputs(kind, c, seed=c + 1):
        tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
        jp, jt = jnp.asarray(preds), jnp.asarray(target)
        _assert_same(tm(tp, tt), jm(jp, jt), exact=exact)
        _assert_same(TF.confusion_matrix(tp, tt, c, normalize=normalize),
                     JF.confusion_matrix(jp, jt, c, normalize=normalize), exact=exact)
    _assert_same(tm.compute(), jm.compute(), exact=exact)
    if exact:
        assert tm.confmat.dtype == torch.int32


def test_multilabel_confusion_matrix_matches_jax():
    jm = J.ConfusionMatrix(num_classes=5, multilabel=True)
    tm = T.ConfusionMatrix(num_classes=5, multilabel=True, device="cpu")
    for preds, target in _inputs("ml_prob", 5, seed=2):
        _assert_same(tm(torch.from_numpy(preds), torch.from_numpy(target)),
                     jm(jnp.asarray(preds), jnp.asarray(target)), exact=True)
    _assert_same(tm.compute(), jm.compute(), exact=True)


def test_confusion_matrix_raises_on_labels_past_num_classes():
    preds, target = torch.tensor([0, 1, 4]), torch.tensor([0, 1, 2])
    with pytest.raises(ValueError, match="Detected class label 4"):
        TF.confusion_matrix(preds, target, num_classes=3)
    with pytest.raises(ValueError, match="Detected class label 4"):
        JF.confusion_matrix(jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()), num_classes=3)
