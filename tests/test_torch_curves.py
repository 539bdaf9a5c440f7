"""The port's curve metrics against the JAX package's.

``AUROC``, ``AveragePrecision``, ``ROC``, ``PrecisionRecallCurve``, ``AUC``
and the binned curves, module and functional, get the same numpy batches on
both sides (binary, multiclass under each ``average``, multilabel), in list
mode and in ``sketched=True`` mode, over several batches and then
``compute()``. Values hold ``rtol=atol=1e-6`` (the JAX side runs with x64
on and returns float64 curves; the port's are float32, asserted apart from
the values); histogram states are equal exactly. On the CPU the sketched
update runs the plain version of kernel B5, which is bit-identical to the
JAX package's eager ``_xla`` formulation. Inside the port, the sketched
values hold the JAX package's documented tolerances against the exact ones
(``tests/kernels/test_sketches.py::TestParityFuzz``).
"""
import warnings

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

CPU = {"device": "cpu"}
HIST_STATES = ("pos_hist", "neg_hist", "sketch_clipped")
CURVES = ("AUROC", "AveragePrecision", "ROC", "PrecisionRecallCurve")


@pytest.fixture(autouse=True)
def _quiet_and_zero_counters():
    _common.reset_dispatch_counters()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "`pos_label` automatically set 1", as in the JAX package
        yield
    _common.reset_dispatch_counters()


def _softmax(x):
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _batches(kind, seed, n=60, c=4, batches=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        if kind == "binary":
            p = rng.rand(n).astype(np.float32)
            out.append((p, (rng.rand(n) < p).astype(np.int64)))
        elif kind == "multiclass":
            out.append((_softmax(rng.randn(n, c) * 2), rng.randint(0, c, n)))
        else:  # multilabel
            p = rng.rand(n, c).astype(np.float32)
            out.append((p, (rng.rand(n, c) < p).astype(np.int64)))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want):
    """Equal structure, float32 port tensors, values within 1e-6, NaN in the same places."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, type(want)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
        return
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32, got
    assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(_np(got), np.asarray(want, dtype=np.float64), rtol=1e-6, atol=1e-6, equal_nan=True)


def _assert_hist_states(port, ref):
    for name in HIST_STATES:
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def _drive(port, ref, batches, forward=False):
    for p, t in batches:
        if forward:
            _assert_close(port(torch.from_numpy(p), torch.from_numpy(t)), ref(jnp.asarray(p), jnp.asarray(t)))
        else:
            port.update(torch.from_numpy(p), torch.from_numpy(t))
            ref.update(jnp.asarray(p), jnp.asarray(t))


def _pair(name, **kwargs):
    return getattr(T, name)(**kwargs, **CPU), getattr(J, name)(**kwargs)


# JAX list mode does not take (N, C) multilabel targets for these curves
# (its per-class recursion hands (N,) scores with (N, C) targets on), so the
# port mirrors only the cases the reference computes.
LIST_CASES = [
    (name, kind, kw)
    for name in CURVES
    for kind, kw in (("binary", {}), ("multiclass", {"num_classes": 4}), ("multilabel", {"num_classes": 4}))
    if not (kind == "multilabel" and name in ("AveragePrecision", "PrecisionRecallCurve"))
]
SKETCH_CASES = [
    (name, kind, kw)
    for name in CURVES
    for kind, kw in (("binary", {}), ("multiclass", {"num_classes": 4}),
                     ("multilabel", {"num_classes": 4, "multilabel": True}))
]


@pytest.mark.parametrize("name,kind,kw", LIST_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("seed", [0, 1])
def test_list_mode_matches_jax(name, kind, kw, seed):
    port, ref = _pair(name, **kw)
    _drive(port, ref, _batches(kind, seed))
    _assert_close(port.compute(), ref.compute())


@pytest.mark.parametrize("name,kind,kw", SKETCH_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("num_bins", [16, 2048])
def test_sketched_mode_matches_jax(name, kind, kw, num_bins):
    port, ref = _pair(name, sketched=True, num_bins=num_bins, **kw)
    _drive(port, ref, _batches(kind, num_bins))
    _assert_hist_states(port, ref)
    _assert_close(port.compute(), ref.compute())
    assert _common.dispatch_count("label_score_histograms", "torch") == 3


@pytest.mark.parametrize("name", ["AUROC", "AveragePrecision"])
@pytest.mark.parametrize("target_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("c", [3, 12])
def test_sketched_multiclass_hands_over_class_ids_and_matches_jax(name, target_dtype, c, monkeypatch):
    """One class against the rest: the sketch update hands the ``(N,)``
    class ids to the histogram function (no ``(N, C)`` one-hot of its own),
    and the states stay the JAX package's bit for bit, the values within 1e-6."""
    from metrics_tpu_torch.utilities import sketching

    seen = []
    onevsrest = sketching._label_score_histograms_onevsrest
    monkeypatch.setattr(sketching, "_label_score_histograms_onevsrest",
                        lambda preds, labels, *a: seen.append(tuple(labels.shape)) or onevsrest(preds, labels, *a))
    monkeypatch.setattr(sketching, "label_score_histograms", None)  # the dense form is not reached
    port, ref = _pair(name, sketched=True, num_bins=64, num_classes=c)
    batches = [(p, t.astype(target_dtype)) for p, t in _batches("multiclass", c, n=50, c=c)]
    _drive(port, ref, batches)
    assert seen == [(50,)] * 3
    _assert_hist_states(port, ref)
    _assert_close(port.compute(), ref.compute())
    assert _common.dispatch_count("label_score_histograms", "torch") == 3


@pytest.mark.parametrize("average", ["macro", "weighted", None])
@pytest.mark.parametrize("sketched", [False, True])
def test_multiclass_auroc_averages_match_jax(average, sketched):
    port, ref = _pair("AUROC", num_classes=4, average=average, sketched=sketched)
    _drive(port, ref, _batches("multiclass", 3))
    _assert_close(port.compute(), ref.compute())


@pytest.mark.parametrize("average", ["macro", "weighted", "micro"])
def test_multilabel_list_auroc_averages_match_jax(average):
    port, ref = _pair("AUROC", num_classes=4, average=average)
    _drive(port, ref, _batches("multilabel", 4))
    _assert_close(port.compute(), ref.compute())


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("sketched", [False, True])
def test_forward_step_values_match_jax(name, sketched):
    port, ref = _pair(name, sketched=sketched, **({"num_bins": 64} if sketched else {}))
    _drive(port, ref, _batches("binary", 5), forward=True)
    _assert_close(port.compute(), ref.compute())
    if sketched:
        _assert_hist_states(port, ref)


def test_sketched_score_range_and_clipping_match_jax():
    rng = np.random.RandomState(6)
    batches = [((rng.randn(80) * 3).astype(np.float32), rng.randint(0, 2, 80)) for _ in range(2)]
    port, ref = _pair("AUROC", sketched=True, num_bins=32, score_range=(-2.0, 2.0))
    _drive(port, ref, batches)
    _assert_hist_states(port, ref)
    assert float(port.sketch_clipped) > 0
    _assert_close(port.compute(), ref.compute())


@pytest.mark.parametrize("name", ["AUROC", "ROC", "PrecisionRecallCurve", "AveragePrecision"])
def test_nan_scores_in_list_mode_sort_as_in_jax(name):
    """JAX sorts the key (-preds, index): NaN last, ties by index;
    ``torch.sort(descending=True)`` would put NaN first."""
    p = np.array([0.3, np.nan, 0.5, np.nan, 0.3, 0.9, 0.1, 0.7], np.float32)
    t = np.array([1, 0, 1, 1, 0, 1, 0, 0])
    port, ref = _pair(name, pos_label=1)
    _drive(port, ref, [(p, t)])
    _assert_close(port.compute(), ref.compute())


def test_sketched_forward_on_a_one_label_batch_raises_like_jax():
    p, t = np.array([0.2, 0.7, 0.4], np.float32), np.array([0, 0, 0])
    port, ref = _pair("AUROC", sketched=True)
    for m, conv in ((ref, jnp.asarray), (port, torch.from_numpy)):
        with pytest.raises(ValueError, match="No positive samples"):
            m(conv(p), conv(t))


@pytest.mark.parametrize("name", ["AUROC", "AveragePrecision"])
@pytest.mark.parametrize("kind,kw", [
    ("binary", {}),
    ("multiclass", {"num_classes": 4}),
    ("multilabel", {"num_classes": 4, "multilabel": True}),
])
@pytest.mark.parametrize("capacity", [500, 100])
def test_capacity_mode_matches_jax(name, kind, kw, capacity):
    """``capacity=`` (the fixed-size sample buffer) against the JAX package:
    states, forward values and compute, within capacity and past it (the
    drop-and-warn default); the modes' exclusions and the sketched mode's
    indifference to ``overflow=`` as in JAX."""
    port, ref = _pair(name, capacity=capacity, **kw)
    _drive(port, ref, _batches(kind, seed=capacity), forward=True)
    np.testing.assert_array_equal(port.buf.numpy(), np.asarray(ref.buf))
    assert int(port.count) == int(ref.count) and port.count.dtype == torch.int32
    _assert_close(port.compute(), ref.compute())
    with pytest.raises(ValueError, match="mutually exclusive"):
        getattr(T, name)(capacity=64, sketched=True, **CPU)
    getattr(T, name)(sketched=True, overflow="error", **CPU)  # ignored by the sketched mode, as in JAX
    with pytest.raises(ValueError, match="overflow"):
        getattr(T, name)(capacity=64, overflow="explode", **CPU)


@pytest.mark.parametrize("kwargs,match", [
    ({"sketched": True, "num_bins": 1}, "num_bins"),
    ({"sketched": True, "score_range": (1.0, 0.0)}, "low < high"),
    ({"sketched": True, "pos_label": 2}, "pos_label"),
    ({"sketched": True, "multilabel": True}, "multilabel"),
    ({"sketched": True, "max_fpr": 0.5}, "max_fpr"),
    ({"multilabel": True}, "hint"),
    ({"average": "samples"}, "average"),
])
def test_constructor_checks_match_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        J.AUROC(**kwargs)
    with pytest.raises(ValueError, match=match):
        T.AUROC(**kwargs, **CPU)


def test_sketched_update_rejects_inputs_of_another_mode():
    port = T.AUROC(sketched=True, num_classes=3, **CPU)
    with pytest.raises(ValueError, match="expects"):
        port.update(torch.rand(8), torch.randint(0, 2, (8,)))
    with pytest.raises(ValueError, match="binary inputs only"):
        T.ROC(sketched=True, **CPU).update(torch.from_numpy(_softmax(np.random.rand(8, 3))), torch.randint(0, 3, (8,)))


# ---------------------------------------------------------------------------
# functionals, AUC, binned curves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,kw", [
    ("binary", {}), ("binary", {"max_fpr": 0.3}), ("multiclass", {"num_classes": 4}),
    ("multiclass", {"num_classes": 4, "average": "weighted"}), ("multiclass", {"num_classes": 4, "average": None}),
    ("multilabel", {"num_classes": 4}), ("multilabel", {"num_classes": 4, "average": "micro"}),
])
def test_functional_auroc_matches_jax(kind, kw):
    p, t = _batches(kind, 7, batches=1)[0]
    _assert_close(TF.auroc(torch.from_numpy(p), torch.from_numpy(t), **kw),
                  JF.auroc(jnp.asarray(p), jnp.asarray(t), **kw))


@pytest.mark.parametrize("fn", ["roc", "precision_recall_curve", "average_precision"])
@pytest.mark.parametrize("kind,kw", [("binary", {"pos_label": 1}), ("multiclass", {"num_classes": 4})])
def test_functional_curves_match_jax(fn, kind, kw):
    p, t = _batches(kind, 8, batches=1)[0]
    got = getattr(TF, fn)(torch.from_numpy(p), torch.from_numpy(t), **kw)
    want = getattr(JF, fn)(jnp.asarray(p), jnp.asarray(t), **kw)
    _assert_close(got, want)


def test_functional_curves_with_sample_weights_match_jax():
    p, t = _batches("binary", 9, batches=1)[0]
    w = np.random.RandomState(9).rand(p.shape[0]).astype(np.float32)
    for fn in ("roc", "precision_recall_curve"):
        got = getattr(TF, fn)(torch.from_numpy(p), torch.from_numpy(t), pos_label=1, sample_weights=w)
        want = getattr(JF, fn)(jnp.asarray(p), jnp.asarray(t), pos_label=1, sample_weights=w)
        _assert_close(got, want)


@pytest.mark.parametrize("x,y,reorder", [
    ([0, 1, 2, 3], [0, 1, 2, 2], False),
    ([3, 2, 1, 0], [2, 2, 1, 0], False),
    ([2, 0, 3, 1], [2, 0, 2, 1], True),
])
def test_auc_matches_jax(x, y, reorder):
    x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
    _assert_close(TF.auc(torch.from_numpy(x), torch.from_numpy(y), reorder=reorder),
                  JF.auc(jnp.asarray(x), jnp.asarray(y), reorder=reorder))
    port, ref = T.AUC(reorder=reorder, **CPU), J.AUC(reorder=reorder)
    for half in (slice(0, 2), slice(2, 4)):
        port.update(torch.from_numpy(x[half]), torch.from_numpy(y[half]))
        ref.update(jnp.asarray(x[half]), jnp.asarray(y[half]))
    _assert_close(port.compute(), ref.compute())


def test_auc_rejects_unordered_x_like_jax():
    x, y = np.asarray([0, 2, 1], np.float32), np.asarray([0, 1, 1], np.float32)
    for fn, conv in ((JF.auc, jnp.asarray), (TF.auc, torch.from_numpy)):
        with pytest.raises(ValueError, match="neither increasing or decreasing"):
            fn(conv(x), conv(y))


@pytest.mark.parametrize("name,kw", [
    ("BinnedPrecisionRecallCurve", {}), ("BinnedAveragePrecision", {}),
    ("BinnedRecallAtFixedPrecision", {"min_precision": 0.5}),
])
@pytest.mark.parametrize("kind,c", [("binary", 1), ("multiclass", 4)])
def test_binned_curves_match_jax(name, kw, kind, c):
    port, ref = _pair(name, num_classes=c, num_thresholds=11, **kw)
    _drive(port, ref, _batches(kind, 10))
    for state in ("TPs", "FPs", "FNs"):
        assert getattr(port, state).dtype == torch.float32
        np.testing.assert_array_equal(getattr(port, state).numpy(), np.asarray(getattr(ref, state)))
    _assert_close(port.compute(), ref.compute())
    assert port.state_dict().keys() == {"thresholds"}
    port.persistent(False)
    assert port.state_dict().keys() == {"thresholds"}  # a buffer stays persistent


# ---------------------------------------------------------------------------
# sketched vs exact inside the port (the JAX package's documented tolerances)
# ---------------------------------------------------------------------------


def _stream(seed, n):
    rng = np.random.RandomState(seed)
    p = rng.rand(n).astype(np.float32)
    return torch.from_numpy(p), torch.from_numpy((rng.rand(n) < p).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("num_bins", [512, 2048])
def test_sketched_auroc_within_5e3_of_exact(seed, num_bins):
    p, t = _stream(seed, 20_000)
    sk, ex = T.AUROC(sketched=True, num_bins=num_bins, **CPU), T.AUROC(**CPU)
    for lo in range(0, 20_000, 5000):
        sk.update(p[lo:lo + 5000], t[lo:lo + 5000])
        ex.update(p[lo:lo + 5000], t[lo:lo + 5000])
    assert abs(float(sk.compute()) - float(ex.compute())) < 5e-3


def test_sketched_average_precision_within_5e3_of_exact():
    p, t = _stream(8, 20_000)
    sk, ex = T.AveragePrecision(sketched=True, **CPU), T.AveragePrecision(**CPU)
    sk.update(p, t)
    ex.update(p, t)
    assert abs(float(sk.compute()) - float(ex.compute())) < 5e-3


@pytest.mark.parametrize("average", ["macro", "weighted"])
def test_sketched_multiclass_auroc_within_1e2_of_exact(average):
    rng = np.random.RandomState(9)
    probs = _softmax(rng.randn(4000, 4))
    labels = np.array([rng.choice(4, p=row / row.sum()) for row in probs.astype(np.float64)])
    sk = T.AUROC(sketched=True, num_classes=4, average=average, **CPU)
    ex = T.AUROC(num_classes=4, average=average, **CPU)
    for m in (sk, ex):
        m.update(torch.from_numpy(probs), torch.from_numpy(labels))
    assert abs(float(sk.compute()) - float(ex.compute())) < 1e-2


def test_sketched_curve_points_lie_on_the_exact_curves():
    p, t = _stream(10, 3000)
    pn, tn = p.numpy(), t.numpy()
    pos, neg = (tn == 1).sum(), (tn == 0).sum()
    roc = T.ROC(sketched=True, num_bins=64, **CPU)
    roc.update(p, t)
    fpr, tpr, thresholds = roc.compute()
    for k in range(1, len(thresholds)):  # skip the synthetic (0, 0) point
        thr = float(thresholds[k])
        np.testing.assert_allclose(float(tpr[k]), ((pn >= thr) & (tn == 1)).sum() / pos, rtol=1e-6)
        np.testing.assert_allclose(float(fpr[k]), ((pn >= thr) & (tn == 0)).sum() / neg, rtol=1e-6)
    prc = T.PrecisionRecallCurve(sketched=True, num_bins=64, **CPU)
    prc.update(p, t)
    precision, recall, thr = prc.compute()
    for k in (0, 13, 63):
        sel = pn >= float(thr[k])
        tp = (sel & (tn == 1)).sum()
        np.testing.assert_allclose(float(recall[k]), tp / pos, rtol=1e-5)
        np.testing.assert_allclose(float(precision[k]), tp / max(sel.sum(), 1), rtol=1e-4)


# ---------------------------------------------------------------------------
# sync, collection, state carried across, keyed
# ---------------------------------------------------------------------------


def _fake_gather(x, group=None):
    return [x, x]


@pytest.mark.parametrize("sketched", [False, True])
def test_sync_adds_histograms_and_concatenates_lists(sketched):
    p, t = _stream(11, 200)
    m = T.AUROC(sketched=sketched, dist_sync_fn=_fake_gather, **CPU)
    m.update(p[:120], t[:120])
    m.update(p[120:], t[120:])
    local = {k: [v.clone() for v in s] if isinstance(s, list) else s.clone() for k, s in m._get_states().items()}
    value = m.compute()  # syncs through the injected gather, then restores the local states
    m.sync(dist_sync_fn=_fake_gather)
    if sketched:
        for name in HIST_STATES:
            assert torch.equal(getattr(m, name), 2 * local[name])
    else:
        assert torch.equal(m.preds, torch.cat([torch.cat(local["preds"])] * 2))
        assert torch.equal(m.target, torch.cat([torch.cat(local["target"])] * 2))
    ref = T.AUROC(sketched=sketched, **CPU)
    ref.update(torch.cat([p, p]), torch.cat([t, t]))
    assert torch.allclose(value, ref.compute(), rtol=1e-6, atol=1e-6)


def test_sketched_collection_updates_and_matches_jax():
    batches = _batches("multiclass", 12, n=80, c=5)
    kw = dict(num_classes=5, sketched=True, num_bins=128, compute_on_step=False)
    port = T.MetricCollection({"AUROC": T.AUROC(**kw, **CPU), "AveragePrecision": T.AveragePrecision(**kw, **CPU)})
    ref = J.MetricCollection({"AUROC": J.AUROC(**kw), "AveragePrecision": J.AveragePrecision(**kw)})
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    assert _common.dispatch_count("label_score_histograms", "torch") == 2 * len(batches)
    got, want = port.compute(), ref.compute()
    for name in ("AUROC", "AveragePrecision"):
        _assert_hist_states(port[name], ref[name])
        _assert_close(got[name], want[name])


@pytest.mark.parametrize("name,kind,kw", [
    ("AUROC", "multiclass", {"num_classes": 4}), ("AveragePrecision", "binary", {}),
    ("ROC", "binary", {}), ("PrecisionRecallCurve", "multiclass", {"num_classes": 4}),
])
@pytest.mark.parametrize("sketched", [False, True])
def test_load_numpy_states_carries_jax_state_across(name, kind, kw, sketched):
    ref = getattr(J, name)(sketched=sketched, **kw)
    _drive(getattr(T, name)(sketched=sketched, **kw, **CPU), ref, _batches(kind, 13))
    states = {k: [np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v)
              for k, v in ref._get_states().items()}
    port = getattr(T, name)(sketched=sketched, **kw, **CPU)
    load_numpy_states(port, states)
    if sketched:
        _assert_hist_states(port, ref)
    _assert_close(port.compute(), ref.compute())


def test_keyed_sketched_auroc_matches_jax_keyed_metric():
    """The event rows under ``torch.func.vmap`` through B5's vmap rule, one
    call of the batched wrapper (its plain version on the CPU), the per-row
    histograms through B3's plain version into four tenants."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 4, 200)
    p = rng.rand(200).astype(np.float32)
    t = (rng.rand(200) < p).astype(np.int64)
    ref = J.KeyedMetric(J.AUROC(sketched=True, num_bins=16), num_tenants=4)
    ref.update(jnp.asarray(ids), jnp.asarray(p), jnp.asarray(t))
    port = T.KeyedMetric(T.AUROC(sketched=True, num_bins=16, **CPU), num_tenants=4, **CPU)
    port.update(torch.from_numpy(ids), torch.from_numpy(p), torch.from_numpy(t))
    assert _common.dispatch_count("segment_scatter_add", "torch") == 1
    assert _common.dispatch_count("label_score_histograms", "torch") == 1  # the vmap rule's one batched call
    _assert_hist_states(port, ref)
    got = port.compute()
    _assert_close(got, ref.compute())
    np.testing.assert_allclose(got.numpy(), [0.7756, 0.8524, 0.8443, 0.8405], atol=1e-4)
    for k in range(4):  # each tenant equals its own stream's AUROC
        alone = T.AUROC(sketched=True, num_bins=16, **CPU)
        alone.update(torch.from_numpy(p[ids == k]), torch.from_numpy(t[ids == k]))
        assert float(alone.compute()) == pytest.approx(float(got[k]), abs=1e-6)


@pytest.mark.parametrize("name,kw", [("AUROC", {}), ("AveragePrecision", {}), ("AUROC", {"num_classes": 4}),
                                     ("AveragePrecision", {"num_classes": 4})])
def test_keyed_sketched_curves_match_the_jax_keyed_metric(name, kw):
    """Binary and one-vs-rest (class ids) keyed sketched curves: the event
    rows under ``torch.func.vmap`` go to B5's batched form in one call an
    update, then B3 routes the per-row histograms, over three updates with a
    partial reset between; states exact, values within 1e-6."""
    rng = np.random.RandomState(7)
    port = T.KeyedMetric(getattr(T, name)(sketched=True, num_bins=32, **kw, **CPU), num_tenants=5, **CPU)
    ref = J.KeyedMetric(getattr(J, name)(sketched=True, num_bins=32, **kw), num_tenants=5)
    for step in range(3):
        if kw:
            p, t = _softmax(rng.rand(90, 4).astype(np.float32)), rng.randint(0, 4, 90)
        else:
            p = rng.rand(90).astype(np.float32)
            t = (rng.rand(90) < p).astype(np.int64)
        ids = rng.randint(0, 5, 90)
        port.update(torch.from_numpy(ids), torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(ids), jnp.asarray(p), jnp.asarray(t))
        if step == 1:
            port.reset(tenant_ids=torch.tensor([2]))
            ref.reset(tenant_ids=jnp.asarray([2]))
    assert _common.dispatch_count("label_score_histograms", "torch") == 3
    assert _common.dispatch_count("segment_scatter_add", "torch") == 3
    _assert_hist_states(port, ref)
    _assert_close(port.compute(), ref.compute())


@pytest.mark.parametrize("kw", [{}, {"num_classes": 4}])
def test_pure_bootstrap_of_a_sketched_auroc_matches_the_jax_package(monkeypatch, kw):
    """The pure ``BootStrapper`` vmaps the child's update over the
    resamples: one batched B5 call an update for the whole stack, the
    children's histograms exact against the JAX package's on the same index
    matrices, the statistics within 1e-6."""
    from tests.test_torch_bootstrapping import _pure_both

    rng = np.random.RandomState(8)
    steps = []
    for _ in range(3):
        if kw:
            steps.append((torch.from_numpy(_softmax(rng.rand(80, 4).astype(np.float32))),
                          torch.from_numpy(rng.randint(0, 4, 80))))
        else:
            p = rng.rand(80).astype(np.float32)
            steps.append((torch.from_numpy(p), torch.from_numpy((rng.rand(80) < p).astype(np.int64))))
    boot_kw = dict(num_bootstraps=6, raw=True, sampling_strategy="multinomial", seed=5)
    jb = J.BootStrapper(J.AUROC(sketched=True, num_bins=64, **kw), **boot_kw)
    tb = T.BootStrapper(T.AUROC(sketched=True, num_bins=64, **kw, **CPU), **boot_kw)
    got, want, tstate, jstate = _pure_both(monkeypatch, jb, tb, steps, "multinomial")
    assert _common.dispatch_count("label_score_histograms", "torch") == len(steps)
    for name in HIST_STATES:
        np.testing.assert_array_equal(tstate["children"][name].numpy(), np.asarray(jstate["children"][name]))
    for key in ("raw", "mean", "std"):
        _assert_close(got[key], want[key])
