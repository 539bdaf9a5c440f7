"""The port's stat-scores family and confusion-matrix family against the JAX package's.

Functional and module ``StatScores``/``Accuracy``/``Precision``/``Recall``/
``FBeta``/``F1``/``Specificity``/``ConfusionMatrix`` and the confusion
matrix's consumers ``IoU``/``CohenKappa``/``MatthewsCorrcoef`` get the same
numpy batches on both sides (binary, multiclass and multilabel), across
``average`` in {micro, macro, weighted, none}, ``ignore_index``,
``absent_score``, ``normalize`` and the kappa ``weights``; the module
metrics run ``forward`` on every batch and ``compute`` at the end. Counts
and confusion matrices must be exact; the float scores are float32 on both
sides and agree within ``rtol=1e-6, atol=1e-7`` (the sums run in another
order), Cohen's kappa within ``rtol=1e-5, atol=1e-6`` (``KAPPA_TOL``). In one collection the new members share the one B1 and B2 update of
their class, and their JAX states carry across (``load_numpy_states``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as JF
import metrics_tpu_torch as T
import metrics_tpu_torch.functional as TF
from metrics_tpu_torch.kernels import _common
from metrics_tpu_torch.utilities.convert import load_numpy_states


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


def _assert_same(got, want, exact=False, rtol=1e-6, atol=1e-7):
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor)
    if exact or not np.issubdtype(want.dtype, np.floating):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol, equal_nan=True)


#: Cohen's kappa is 1 - k, k a ratio of two float32 sums over C^2 terms near
#: 1: the sums in another order differ by a few ulps of k (1.2e-7 each), which
#: 1 - k keeps as absolute error
KAPPA_TOL = dict(rtol=1e-5, atol=1e-6)


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
    ("Specificity", "specificity", {}),
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


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_binary_specificity_matches_jax(average):
    kwargs = dict(average=average, num_classes=1 if average == "micro" else 2, multiclass=average != "micro")
    jm, tm = J.Specificity(**kwargs), T.Specificity(device="cpu", **kwargs)
    for batch_idx, (preds, target) in enumerate(_inputs("bin_prob", 2, seed=31)):
        tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
        jp, jt = jnp.asarray(preds), jnp.asarray(target)
        _assert_same(tm(tp, tt), jm(jp, jt))
        if batch_idx == 0:
            _assert_same(TF.specificity(tp, tt, **kwargs), JF.specificity(jp, jt, **kwargs))
    _assert_same(tm.compute(), jm.compute())


# binary, multiclass (scores and labels, a wide C) and multilabel inputs; the
# multilabel rows count every label's (pred, target) pair into a 2x2 matrix
CONFMAT_KINDS = [("bin_prob", 2), ("mc_prob", 5), ("mc", 4), ("mc_prob", 129), ("ml_prob", 2)]
CONFMAT_METRICS = [
    ("IoU", "iou", {}),
    ("IoU", "iou", {"ignore_index": 0}),
    ("IoU", "iou", {"ignore_index": 1, "reduction": "none"}),
    ("IoU", "iou", {"reduction": "sum"}),
    ("CohenKappa", "cohen_kappa", {}),
    ("CohenKappa", "cohen_kappa", {"weights": "linear"}),
    ("CohenKappa", "cohen_kappa", {"weights": "quadratic"}),
    ("MatthewsCorrcoef", "matthews_corrcoef", {}),
]


@pytest.mark.parametrize("kind, c", CONFMAT_KINDS)
@pytest.mark.parametrize("cls_name, fn_name, kwargs", CONFMAT_METRICS,
                         ids=[f"{m[0]}-{'-'.join(f'{k}={v}' for k, v in m[2].items())}" for m in CONFMAT_METRICS])
def test_confmat_family_matches_jax(cls_name, fn_name, kwargs, kind, c):
    jm = getattr(J, cls_name)(num_classes=c, **kwargs)
    tm = getattr(T, cls_name)(num_classes=c, device="cpu", **kwargs)
    tol = KAPPA_TOL if cls_name == "CohenKappa" else {}
    for batch_idx, (preds, target) in enumerate(_inputs(kind, c, seed=c + 17)):
        tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
        jp, jt = jnp.asarray(preds), jnp.asarray(target)
        _assert_same(tm(tp, tt), jm(jp, jt), **tol)
        if batch_idx == 0:
            _assert_same(getattr(TF, fn_name)(tp, tt, num_classes=c, **kwargs),
                         getattr(JF, fn_name)(jp, jt, num_classes=c, **kwargs), **tol)
    _assert_same(tm.compute(), jm.compute(), **tol)
    assert tm.confmat.dtype == torch.int32


@pytest.mark.parametrize("reduction", ["elementwise_mean", "none"])
def test_iou_scores_an_absent_class_with_absent_score(reduction):
    preds, target = np.asarray([0, 1, 2, 2, 1]), np.asarray([0, 1, 1, 2, 2])  # class 3 appears nowhere
    kwargs = dict(num_classes=4, absent_score=0.25, reduction=reduction)
    tm, jm = T.IoU(device="cpu", **kwargs), J.IoU(**kwargs)
    _assert_same(tm(torch.from_numpy(preds), torch.from_numpy(target)), jm(jnp.asarray(preds), jnp.asarray(target)))
    _assert_same(TF.iou(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
                 JF.iou(jnp.asarray(preds), jnp.asarray(target), **kwargs))


def _new_members(pkg, c, **device):
    kw = dict(average="macro", num_classes=c, **device)
    return pkg.MetricCollection({
        "Precision": pkg.Precision(**kw), "Specificity": pkg.Specificity(**kw),
        "ConfusionMatrix": pkg.ConfusionMatrix(c, **device), "IoU": pkg.IoU(c, **device),
        "CohenKappa": pkg.CohenKappa(c, **device), "MatthewsCorrcoef": pkg.MatthewsCorrcoef(c, **device),
    })


def test_new_members_share_one_update_per_class_in_a_collection():
    c = 6
    tc, jc = _new_members(T, c, device="cpu"), _new_members(J, c)
    assert sorted(map(sorted, tc._class_groups().values())) == [
        ["CohenKappa", "ConfusionMatrix", "IoU", "MatthewsCorrcoef"], ["Precision", "Specificity"]]
    _common.reset_dispatch_counters()
    batches = _inputs("mc_prob", c, seed=40)
    for preds, target in batches:
        got = tc(torch.from_numpy(preds), torch.from_numpy(target))
        want = jc(jnp.asarray(preds), jnp.asarray(target))
        for k in want:
            _assert_same(got[k], want[k], **(KAPPA_TOL if k == "CohenKappa" else {}))
    # one count pass of each kind per batch, whatever the number of members
    assert _common.dispatch_count("confmat_counts", "torch") == len(batches)
    assert _common.dispatch_count("stat_scores_counts", "torch") == len(batches)
    got, want = tc.compute(), jc.compute()
    for k in want:
        _assert_same(got[k], want[k], **(KAPPA_TOL if k == "CohenKappa" else {}))


def test_jax_states_of_the_new_members_carry_across():
    c = 5
    tc, jc = _new_members(T, c, device="cpu"), _new_members(J, c)
    (p0, t0), (p1, t1) = _inputs("mc_prob", c, seed=41, batches=2)
    jc.update(jnp.asarray(p0), jnp.asarray(t0))
    load_numpy_states(tc, {name: {k: np.asarray(v) for k, v in m._get_states().items()}
                           for name, m in jc.items(keep_base=True)})
    for pkg_coll, pkg_arr in ((jc, jnp.asarray), (tc, torch.from_numpy)):
        pkg_coll.update(pkg_arr(p1), pkg_arr(t1))
    got, want = tc.compute(), jc.compute()
    for k in want:
        _assert_same(got[k], want[k], **(KAPPA_TOL if k == "CohenKappa" else {}))
    assert tc["IoU"].confmat.dtype == torch.int32 and tc["Specificity"].tn.dtype == torch.int32
