"""The port's input canonicalization against the JAX package's.

``_input_format_classification`` of ``metrics_tpu_torch`` and of
``metrics_tpu`` get the same numpy inputs over the case matrix of
``tests/classification/test_inputs.py`` (binary, multi-label, multi-class,
multi-dim multi-class, top-k, threshold, the ``multiclass`` overrides and
the error matrix); outputs, dtypes and inferred cases must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.utilities.checks import _input_format_classification as jax_format
from metrics_tpu_torch.utilities.checks import _input_format_classification as torch_format
from tests.classification.inputs import (
    Input,
    _binary_inputs as _bin,
    _binary_prob_inputs as _bin_prob,
    _multiclass_inputs as _mc,
    _multiclass_prob_inputs as _mc_prob,
    _multidim_multiclass_inputs as _mdmc,
    _multidim_multiclass_prob_inputs as _mdmc_prob,
    _multilabel_inputs as _ml,
    _multilabel_multidim_inputs as _mlmd,
    _multilabel_multidim_prob_inputs as _mlmd_prob,
    _multilabel_prob_inputs as _ml_prob,
)
from tests.helpers.testers import BATCH_SIZE, EXTRA_DIM, NUM_CLASSES, THRESHOLD

_rng = np.random.RandomState(17)

_ml_prob_half = Input(_ml_prob.preds.astype(np.float16), _ml_prob.target)
_mc_prob_2cls_preds = _rng.rand(2, BATCH_SIZE, 2)
_mc_prob_2cls_preds /= _mc_prob_2cls_preds.sum(axis=2, keepdims=True)
_mc_prob_2cls = Input(_mc_prob_2cls_preds, _rng.randint(0, 2, (2, BATCH_SIZE)))
_mdmc_prob_many_dims_preds = _rng.rand(2, BATCH_SIZE, NUM_CLASSES, EXTRA_DIM, EXTRA_DIM)
_mdmc_prob_many_dims_preds /= _mdmc_prob_many_dims_preds.sum(axis=2, keepdims=True)
_mdmc_prob_many_dims = Input(
    _mdmc_prob_many_dims_preds, _rng.randint(0, 2, (2, BATCH_SIZE, EXTRA_DIM, EXTRA_DIM))
)
_mdmc_prob_2cls_preds = _rng.rand(2, BATCH_SIZE, 2, EXTRA_DIM)
_mdmc_prob_2cls_preds /= _mdmc_prob_2cls_preds.sum(axis=2, keepdims=True)
_mdmc_prob_2cls = Input(_mdmc_prob_2cls_preds, _rng.randint(0, 2, (2, BATCH_SIZE, EXTRA_DIM)))
_mc_prob_wide = Input(_rng.rand(2, BATCH_SIZE, 129).astype(np.float32), _rng.randint(0, 129, (2, BATCH_SIZE)))


def _both(preds, target, **kwargs):
    jp, jt, jmode = jax_format(jnp.asarray(preds), jnp.asarray(target), threshold=THRESHOLD, **kwargs)
    tp, tt, tmode = torch_format(torch.from_numpy(np.asarray(preds)), torch.from_numpy(np.asarray(target)),
                                 threshold=THRESHOLD, **kwargs)
    return (np.asarray(jp), np.asarray(jt), jmode), (tp, tt, tmode)


@pytest.mark.parametrize(
    "inputs, num_classes, multiclass, top_k",
    [
        (_bin, None, False, None),
        (_bin, 1, False, None),
        (_bin_prob, None, None, None),
        (_ml_prob, None, None, None),
        (_ml, None, False, None),
        (_ml_prob, None, None, 2),
        (_mlmd, None, False, None),
        (_mc, NUM_CLASSES, None, None),
        (_mc, None, None, None),
        (_mc_prob, None, None, None),
        (_mc_prob, None, None, 2),
        (_mc_prob_wide, None, None, None),
        (_mc_prob_wide, 129, None, 3),
        (_mdmc, NUM_CLASSES, None, None),
        (_mdmc_prob, None, None, None),
        (_mdmc_prob, None, None, 2),
        (_mdmc_prob_many_dims, None, None, None),
        (_mdmc_prob_many_dims, None, None, 2),
        (_ml_prob_half, None, None, None),
        (_bin, None, None, None),
        (_bin_prob, None, True, None),
        (_ml, None, True, None),
        (_ml_prob, None, True, None),
        (_mlmd, None, True, None),
        (_mlmd_prob, None, True, None),
        (_mc_prob_2cls, None, False, None),
        (_mdmc_prob_2cls, None, False, None),
    ],
)
def test_input_format_matches_jax(inputs, num_classes, multiclass, top_k):
    for preds, target in [
        (inputs.preds[0], inputs.target[0]),
        (inputs.preds[0][[0], ...], inputs.target[0][[0], ...]),  # batch of one: the squeeze rules
    ]:
        (jp, jt, jmode), (tp, tt, tmode) = _both(
            preds, target, num_classes=num_classes, multiclass=multiclass, top_k=top_k
        )
        assert tmode == jmode
        assert tp.dtype == torch.int32 and tt.dtype == torch.int32
        np.testing.assert_array_equal(tp.numpy(), jp)
        np.testing.assert_array_equal(tt.numpy(), jt)


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7])
def test_threshold_matches_jax(threshold):
    target = np.asarray([1, 1, 1, 0, 0])
    preds = np.asarray([threshold - 1e-5, threshold, threshold + 1e-5, 0.0, 1.0], np.float32)
    jp, _, _ = jax_format(jnp.asarray(preds), jnp.asarray(target), threshold=threshold)
    tp, _, _ = torch_format(torch.from_numpy(preds), torch.from_numpy(target), threshold=threshold)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _ri(*shape, low=0, high=2):
    return _rng.randint(low, high, shape)


@pytest.mark.parametrize(
    "preds, target, num_classes, multiclass, top_k",
    [
        (_ri(7), _ri(7).astype(float), None, None, None),  # target not integer
        (_ri(7), -_ri(7) - 1, None, None, None),  # target negative
        (-_ri(7) - 1, _ri(7), None, None, None),  # preds negative integers
        (_rng.rand(7), _ri(7, low=2, high=4), None, False, None),  # multiclass=False, target > 1
        (_ri(7, low=2, high=4), _ri(7), None, False, None),  # multiclass=False, int preds > 1
        (_ri(8), _ri(7), None, None, None),  # wrong batch size
        (_ri(7), _ri(7, 4), None, None, None),  # completely wrong shape
        (_ri(7, 3), _ri(7, 4), None, None, None),  # same ndim, different shape
        (_rng.rand(7, 3), _ri(7, 3, low=2, high=4), None, None, None),  # float preds, non-binary target
        (_rng.rand(7, 3, 4, 3), _ri(7, 3, 3, high=4), None, None, None),  # C not in dim 1
        (_ri(7, 3, 3, 4), _ri(7, 3, 3, high=4), None, None, None),  # extra dim but int preds
        (_mc_prob.preds[0], _ri(BATCH_SIZE), None, False, None),  # multiclass=False, C > 2
        (_mc_prob.preds[0], _ri(BATCH_SIZE, low=NUM_CLASSES + 1, high=100), None, None, None),  # target >= C
        (_mc_prob.preds[0], _mc_prob.target[0], NUM_CLASSES + 1, None, None),  # C != num_classes
        (_ri(7, 3, high=4), _ri(7, 3, low=5, high=7), 4, None, None),  # target > num_classes
        (_ri(7, 3, low=5, high=7), _ri(7, 3, high=4), 4, None, None),  # preds > num_classes
        (_ri(7), _ri(7), 1, None, None),  # num_classes=1 without multiclass=False
        (_ri(7, 3, 3), _ri(7, 3, 3), 4, False, None),  # implied class dim != num_classes
        (_rng.rand(7, 3, 3), _ri(7, 3, 3), 4, False, None),  # ml with implied dim != num_classes
        (_rng.rand(7, 3), _ri(7, 3), 4, True, None),  # ml multiclass=True but num_classes != 2
        (_rng.rand(7), _ri(7), 4, None, None),  # binary, num_classes > 2
        (_rng.rand(7), _ri(7), 2, None, None),  # binary, num_classes=2 without multiclass=True
        (_rng.rand(7), _ri(7), 1, True, None),  # binary, num_classes=1 with multiclass=True
        (_bin.preds[0], _bin.target[0], None, None, 2),  # top_k on label data
        (_bin_prob.preds[0], _bin_prob.target[0], None, None, 2),  # top_k on binary probs
        (_mc_prob_2cls.preds[0], _mc_prob_2cls.target[0], None, None, 0),  # top_k = 0
        (_mc_prob_2cls.preds[0], _mc_prob_2cls.target[0], None, False, 2),  # top_k with mc=False
        (_mc_prob.preds[0], _mc_prob.target[0], None, None, NUM_CLASSES),  # top_k = C
        (_ml_prob.preds[0], _ml_prob.target[0], None, True, 2),  # ml probs mc=True with top_k
    ],
)
def test_incorrect_inputs_raise_like_jax(preds, target, num_classes, multiclass, top_k):
    kwargs = dict(threshold=THRESHOLD, num_classes=num_classes, multiclass=multiclass, top_k=top_k)
    with pytest.raises(ValueError) as jax_err:
        jax_format(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    with pytest.raises(ValueError) as torch_err:
        torch_format(torch.from_numpy(np.asarray(preds)), torch.from_numpy(np.asarray(target)), **kwargs)
    assert str(torch_err.value).split(",")[0] == str(jax_err.value).split(",")[0]
