"""The port's last classification leftovers against the JAX package's.

``hamming_distance``/``HammingDistance``, ``dice_score``, ``hinge``/``Hinge``
(binary, multiclass Crammer-Singer and one-vs-all, plain and squared) and
``kldivergence``/``KLDivergence`` (probabilities and log-probabilities, every
reduction) get the same seeded numpy inputs on both sides; the module
metrics run ``forward`` on every batch and ``compute`` at the end. The JAX
side runs in float64 wherever it does not cast (``tests/conftest.py``
turns on x64), the port in float32, so floats agree within ``rtol=1e-5,
atol=1e-6``. Equal bad inputs raise the same error type with the same
message on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as JF
import metrics_tpu_torch as T
import metrics_tpu_torch.functional as TF

CPU = {"device": "cpu"}
TOL = dict(rtol=1e-5, atol=1e-6)


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _close(got, want):
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), equal_nan=True, **TOL)


def _batches(kind, seed, n=32, c=5, batches=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        if kind == "bin_prob":
            out.append((rng.rand(n).astype(np.float32), rng.randint(0, 2, n)))
        elif kind == "bin_label":
            out.append((rng.randint(0, 2, n), rng.randint(0, 2, n)))
        elif kind == "ml_prob":
            out.append((rng.rand(n, c).astype(np.float32), rng.randint(0, 2, (n, c))))
        elif kind == "mc_prob":
            out.append((_softmax(rng.randn(n, c), 1), rng.randint(0, c, n)))
        elif kind == "mdmc_prob":
            out.append((_softmax(rng.randn(n, c, 3), 1), rng.randint(0, c, (n, 3))))
        elif kind == "scores":
            out.append((rng.randn(n, c).astype(np.float32), rng.randint(0, c, n)))
        elif kind == "bin_scores":
            out.append((rng.randn(n).astype(np.float32), rng.randint(0, 2, n)))
        elif kind == "dists":
            out.append((_softmax(rng.randn(n, c)), _softmax(rng.randn(n, c))))
    return out


def _run_module(jax_metric, port_metric, batches, convert=None):
    convert = convert or (lambda a: a)
    for a, b in batches:
        a, b = convert(a), convert(b)
        _close(port_metric(torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b))),
               jax_metric(jnp.asarray(a), jnp.asarray(b)))
    _close(port_metric.compute(), jax_metric.compute())


def _same_error(port_call, jax_call):
    with pytest.raises(Exception) as port_err:
        port_call()
    with pytest.raises(Exception) as jax_err:
        jax_call()
    assert type(port_err.value) is type(jax_err.value)
    assert str(port_err.value) == str(jax_err.value)


# -- hamming distance --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bin_prob", "bin_label", "ml_prob", "mc_prob", "mdmc_prob"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_hamming_distance(kind, threshold):
    batches = _batches(kind, seed=1)
    for preds, target in batches:
        _close(TF.hamming_distance(torch.from_numpy(preds), torch.from_numpy(target), threshold=threshold),
               JF.hamming_distance(jnp.asarray(preds), jnp.asarray(target), threshold=threshold))
    _run_module(J.HammingDistance(threshold=threshold), T.HammingDistance(threshold=threshold, **CPU), batches)


@pytest.mark.parametrize("threshold", [0.0, 1.0, 1.5])
def test_hamming_distance_rejects_a_threshold_outside_the_unit_interval(threshold):
    _same_error(lambda: T.HammingDistance(threshold=threshold, **CPU), lambda: J.HammingDistance(threshold=threshold))


# -- dice --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mc_prob", "mdmc_prob"])
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_dice_score(kind, bg, reduction):
    for preds, target in _batches(kind, seed=2, c=4):
        _close(TF.dice_score(torch.from_numpy(preds), torch.from_numpy(target), bg=bg, reduction=reduction),
               JF.dice_score(jnp.asarray(preds), jnp.asarray(target), bg=bg, reduction=reduction))


@pytest.mark.parametrize("bg", [False, True])
def test_dice_score_nan_and_no_foreground_scores(bg):
    # class 3 is never predicted nor a target (denominator 0 -> nan_score),
    # class 2 is predicted but never a target (no_fg_score)
    preds = np.eye(4, dtype=np.float32)[[0, 1, 2, 1, 0, 2]]
    target = np.array([0, 1, 1, 1, 0, 0])
    kwargs = dict(bg=bg, nan_score=-1.0, no_fg_score=7.0, reduction="none")
    _close(TF.dice_score(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
           JF.dice_score(jnp.asarray(preds), jnp.asarray(target), **kwargs))


def test_dice_score_rejects_an_unknown_reduction():
    preds, target = _batches("mc_prob", seed=3, batches=1)[0]
    _same_error(lambda: TF.dice_score(torch.from_numpy(preds), torch.from_numpy(target), reduction="max"),
                lambda: JF.dice_score(jnp.asarray(preds), jnp.asarray(target), reduction="max"))


# -- hinge -------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kind, mode",
    [("bin_scores", None), ("scores", None), ("scores", "crammer-singer"), ("scores", "one-vs-all")],
)
@pytest.mark.parametrize("squared", [False, True])
def test_hinge(kind, mode, squared):
    batches = _batches(kind, seed=4)
    for preds, target in batches:
        _close(TF.hinge(torch.from_numpy(preds), torch.from_numpy(target), squared=squared, multiclass_mode=mode),
               JF.hinge(jnp.asarray(preds), jnp.asarray(target), squared=squared, multiclass_mode=mode))
    _run_module(J.Hinge(squared=squared, multiclass_mode=mode),
                T.Hinge(squared=squared, multiclass_mode=mode, **CPU), batches)


@pytest.mark.parametrize("mode", [None, "one-vs-all"])
def test_hinge_with_a_batch_of_one_row(mode):
    preds, target = np.array([[0.3, -1.2, 2.0]], dtype=np.float32), np.array([1])
    _close(TF.hinge(torch.from_numpy(preds), torch.from_numpy(target), multiclass_mode=mode),
           JF.hinge(jnp.asarray(preds), jnp.asarray(target), multiclass_mode=mode))


@pytest.mark.parametrize(
    "preds_shape, target_shape, mode",
    [((8,), (8, 2), None), ((8, 3, 2), (8,), None), ((8,), (7,), None), ((8, 3), (7,), None), ((8, 3), (8,), "ova")],
)
def test_hinge_raises_as_the_reference_does(preds_shape, target_shape, mode):
    rng = np.random.RandomState(5)
    preds, target = rng.randn(*preds_shape).astype(np.float32), rng.randint(0, 2, target_shape)
    _same_error(lambda: TF.hinge(torch.from_numpy(preds), torch.from_numpy(target), multiclass_mode=mode),
                lambda: JF.hinge(jnp.asarray(preds), jnp.asarray(target), multiclass_mode=mode))


def test_hinge_module_rejects_an_unknown_mode():
    _same_error(lambda: T.Hinge(multiclass_mode="ova", **CPU), lambda: J.Hinge(multiclass_mode="ova"))


# -- KL divergence -----------------------------------------------------------------


@pytest.mark.parametrize("log_prob", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
def test_kldivergence(log_prob, reduction):
    batches = _batches("dists", seed=6)
    convert = (lambda a: np.log(a)) if log_prob else None
    for p, q in batches:
        if log_prob:
            p, q = np.log(p), np.log(q)
        _close(TF.kldivergence(torch.from_numpy(p), torch.from_numpy(q), log_prob=log_prob, reduction=reduction),
               JF.kldivergence(jnp.asarray(p), jnp.asarray(q), log_prob=log_prob, reduction=reduction))
    _run_module(J.KLDivergence(log_prob=log_prob, reduction=reduction),
                T.KLDivergence(log_prob=log_prob, reduction=reduction, **CPU), batches, convert)


def test_kldivergence_unnormalized_rows_are_normalized():
    rng = np.random.RandomState(7)
    p, q = rng.rand(6, 4).astype(np.float32) * 3, rng.rand(6, 4).astype(np.float32)
    _close(TF.kldivergence(torch.from_numpy(p), torch.from_numpy(q)), JF.kldivergence(jnp.asarray(p), jnp.asarray(q)))


@pytest.mark.parametrize("p_shape, q_shape", [((4, 3), (4, 2)), ((4,), (4,)), ((2, 2, 3), (2, 2, 3))])
def test_kldivergence_raises_as_the_reference_does(p_shape, q_shape):
    rng = np.random.RandomState(8)
    p, q = rng.rand(*p_shape).astype(np.float32), rng.rand(*q_shape).astype(np.float32)
    _same_error(lambda: TF.kldivergence(torch.from_numpy(p), torch.from_numpy(q)),
                lambda: JF.kldivergence(jnp.asarray(p), jnp.asarray(q)))


@pytest.mark.parametrize("kwargs", [{"reduction": "max"}, {"log_prob": 1}])
def test_kldivergence_module_rejects_bad_arguments(kwargs):
    _same_error(lambda: T.KLDivergence(**kwargs, **CPU), lambda: J.KLDivergence(**kwargs))


def test_leftovers_are_exported_as_the_jax_package_exports_them():
    for name in ("HammingDistance", "Hinge", "KLDivergence", "AverageMeter", "CompositionalMetric"):
        assert hasattr(T, name) and hasattr(J, name)
    for name in ("hamming_distance", "dice_score", "hinge", "kldivergence"):
        assert hasattr(TF, name) and hasattr(JF, name)
