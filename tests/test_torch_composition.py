"""The port's ``CompositionalMetric``, its operators and ``AverageMeter``.

Mirrors ``tests/bases/test_composition.py`` and ``tests/bases/test_average.py``
on the port (``device="cpu"``): every operator form (binary, reflected,
comparison, bitwise, unary, indexing) against its expected value AND the
JAX package's composition of the same operands; per-child keyword
filtering, the reset fan-out, the forward protocol (the reference's double
update, whose reset leaves the children with the last batch), the pure API
with child states keyed ``"a"``/``"b"`` and the refusal of a compiled
forward, with the JAX package's error. Floats agree within ``rtol=1e-6``
(the JAX side runs in float64 under ``tests/conftest.py``'s x64).
"""
import operator

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
from metrics_tpu.metric import CompositionalMetric as JCompositionalMetric
from metrics_tpu.metric import Metric as JMetric
import metrics_tpu_torch as T
from metrics_tpu_torch.metric import CompositionalMetric, Metric

CPU = {"device": "cpu"}


class DummyMetric(Metric):
    def __init__(self, val_to_return):
        super().__init__(**CPU)
        self.add_state("_num_updates", torch.zeros(()), dist_reduce_fx="sum")
        self._val_to_return = val_to_return

    def update(self, *args, **kwargs) -> None:
        self._num_updates = self._num_updates + 1

    def compute(self):
        return torch.as_tensor(self._val_to_return)


class JDummyMetric(JMetric):
    def __init__(self, val_to_return):
        super().__init__()
        self.add_state("_num_updates", jnp.zeros(()), dist_reduce_fx="sum")
        self._val_to_return = val_to_return

    def update(self, *args, **kwargs) -> None:
        self._num_updates = self._num_updates + 1

    def compute(self):
        return jnp.asarray(self._val_to_return)


def _value(comp):
    comp.update()
    return comp.compute()


def _pair(build, val, operand=None):
    """The same composition built on both packages: ``build(metric, operand)``
    with a dummy returning ``val`` (an operand that is a value is converted
    per package; ``"metric:<v>"`` makes it a second dummy)."""
    def port_operand():
        if isinstance(operand, str):
            return DummyMetric(float(operand.split(":")[1]))
        return torch.as_tensor(operand) if isinstance(operand, np.ndarray) else operand

    def jax_operand():
        if isinstance(operand, str):
            return JDummyMetric(float(operand.split(":")[1]))
        return jnp.asarray(operand) if isinstance(operand, np.ndarray) else operand

    return build(DummyMetric(val), port_operand()), build(JDummyMetric(val), jax_operand())


BINARY = [
    ("add", operator.add, 2, "metric:2", 4),
    ("add_int", operator.add, 2, 2, 4),
    ("add_float", operator.add, 2, 2.0, 4.0),
    ("add_tensor", operator.add, 2, np.asarray(2), 4),
    ("radd", lambda m, o: o + m, 2, 2, 4),
    ("radd_tensor", lambda m, o: o + m, 2, np.asarray(2), 4),
    ("mul", operator.mul, 2, "metric:3", 6),
    ("mul_int", operator.mul, 2, 3, 6),
    ("rmul_float", lambda m, o: o * m, 2, 3.0, 6.0),
    ("sub", operator.sub, 2, "metric:3", -1),
    ("sub_int", operator.sub, 2, 3, -1),
    ("rsub", lambda m, o: o - m, 2, 5, 3),
    ("truediv", operator.truediv, 2, "metric:3", 2 / 3),
    ("truediv_int", operator.truediv, 2, 3, 2 / 3),
    ("rtruediv", lambda m, o: o / m, 2, 6, 3.0),
    ("floordiv", operator.floordiv, 5, 2, 2),
    ("mod", operator.mod, 5, 2, 1),
    ("pow", operator.pow, 5, 2, 25),
    ("rfloordiv", lambda m, o: o // m, 2, 5, 2),
    ("rmod", lambda m, o: o % m, 2, 5, 1),
    ("rpow", lambda m, o: o**m, 2, 5, 25),
    ("and", operator.and_, 5, 3, 5 & 3),
    ("or", operator.or_, 5, 3, 5 | 3),
    ("xor", operator.xor, 5, 3, 5 ^ 3),
    ("rand", lambda m, o: o & m, 2, 5, 5 & 2),
    ("ror", lambda m, o: o | m, 2, 5, 5 | 2),
    ("rxor", lambda m, o: o ^ m, 2, 5, 5 ^ 2),
    ("matmul", operator.matmul, [2.0, 2.0, 2.0], np.asarray([2.0, 2.0, 2.0], np.float32), 12.0),
    ("rmatmul", lambda m, o: o @ m, [2.0, 2.0, 2.0], np.asarray([1.0, 2.0, 3.0], np.float32), 12.0),
    ("eq", operator.eq, 2, 2, True),
    ("ne", operator.ne, 2, 2, False),
    ("gt", operator.gt, 2, 1, True),
    ("ge", operator.ge, 2, 2, True),
    ("lt", operator.lt, 2, 1, False),
    ("le", operator.le, 2, 2, True),
]


@pytest.mark.parametrize("name, build, val, operand, expected", BINARY, ids=[b[0] for b in BINARY])
def test_binary_operators_equal_the_expected_value_and_the_jax_package(name, build, val, operand, expected):
    port, ref = _pair(build, val, operand)
    assert isinstance(port, CompositionalMetric) and isinstance(ref, JCompositionalMetric)
    got = _value(port)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(_value(ref)), rtol=1e-6)


UNARY = [
    ("abs", abs, -2, 2),
    ("neg", operator.neg, -2, -2),
    ("pos", operator.pos, -2, 2),
    ("invert", operator.invert, 5, ~np.int32(5)),
    ("getitem", lambda m: m[1], [1.0, 2.0, 3.0], 2.0),
]


@pytest.mark.parametrize("name, build, val, expected", UNARY, ids=[u[0] for u in UNARY])
def test_unary_operators_equal_the_expected_value_and_the_jax_package(name, build, val, expected):
    port, ref = build(DummyMetric(val)), build(JDummyMetric(val))
    got = _value(port)
    np.testing.assert_allclose(got.numpy(), expected)
    np.testing.assert_allclose(got.numpy(), np.asarray(_value(ref)))


FLOORDIV_CASES = [
    (5.0, 0.0, np.inf), (-5.0, 0.0, -np.inf), (0.0, 0.0, np.nan),
    (8.754882, -0.09516175, -93.0),  # floor(a / b) alone would give -92
    (7.0, 2.0, 3.0), (-7.0, 2.0, -4.0),
    (5.0, np.inf, 0.0), (-5.0, np.inf, -1.0), (5.0, -np.inf, -1.0),
]


@pytest.mark.parametrize("val, divisor, expected", FLOORDIV_CASES)
def test_floordiv_has_torch_semantics(val, divisor, expected):
    got = _value(DummyMetric(val) // divisor)
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_value(JDummyMetric(val) // divisor)))


def test_integer_floordiv_stays_integer():
    result = _value(DummyMetric(5) // 2)
    assert not result.is_floating_point() and int(result) == 2


MOD_CASES = [
    (5.0, 3.0, 2.0), (-5.0, 3.0, -2.0), (5.0, -3.0, 2.0),
    (5.0, np.inf, 5.0), (-5.0, np.inf, -5.0), (5.0, -np.inf, 5.0),
    (0.0, np.inf, 0.0), (5.0, 0.0, np.nan),
]


@pytest.mark.parametrize("val, divisor, expected", MOD_CASES)
def test_mod_is_fmod(val, divisor, expected):
    got = _value(DummyMetric(val) % divisor)
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_value(JDummyMetric(val) % divisor)))


def test_compositional_update_and_reset_fan_out():
    a, b = DummyMetric(2), DummyMetric(3)
    comp = a + b
    comp.update()
    assert int(a._num_updates) == 1 and int(b._num_updates) == 1
    comp.reset()
    assert int(a._num_updates) == 0 and int(b._num_updates) == 0


def test_nested_composition():
    a, b = DummyMetric(2), DummyMetric(3)
    np.testing.assert_allclose(_value((a + b) * 2).numpy(), 10)


class _Kwargs(DummyMetric):
    """Records the keywords its update got."""

    def update(self, preds=None, target=None, *, weight=None) -> None:
        self.seen = (preds, target, weight)
        self._num_updates = self._num_updates + 1


class _OtherKwargs(DummyMetric):
    def update(self, preds=None, *, scale=None) -> None:
        self.seen = (preds, scale)
        self._num_updates = self._num_updates + 1


def test_update_filters_the_keywords_per_child():
    a, b = _Kwargs(1.0), _OtherKwargs(2.0)
    comp = a * b
    comp.update(preds=1, target=2, weight=3, scale=4)
    assert a.seen == (1, 2, 3) and b.seen == (1, 4)


def test_forward_returns_the_batch_value():
    np.testing.assert_allclose((DummyMetric(2) + 3)().numpy(), 5)


def test_forward_of_a_composition_keeps_only_the_last_batch_as_the_jax_package_does():
    rng = np.random.RandomState(0)
    comp = T.Accuracy(**CPU) + T.Precision(average="micro", **CPU)
    ref = J.Accuracy() + J.Precision(average="micro")
    for _ in range(3):
        p, t = rng.rand(16, 4).astype(np.float32), rng.randint(0, 4, 16)
        np.testing.assert_allclose(comp(torch.from_numpy(p), torch.from_numpy(t)).numpy(),
                                   np.asarray(ref(jnp.asarray(p), jnp.asarray(t))), rtol=1e-6)
    # the double-update forward resets the children before the batch value
    last = T.Accuracy(**CPU)
    last.update(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_array_equal(comp.metric_a.compute().numpy(), last.compute().numpy())
    np.testing.assert_allclose(comp.compute().numpy(), np.asarray(ref.compute()), rtol=1e-6)


def test_pure_api_equals_the_eager_composition():
    rng = np.random.RandomState(0)
    cases = [
        (T.Accuracy(**CPU) + T.Precision(average="micro", **CPU), J.Accuracy() + J.Precision(average="micro")),
        (T.Accuracy(**CPU) * 2.0, J.Accuracy() * 2.0),
        (2.0 - T.Accuracy(**CPU), 2.0 - J.Accuracy()),
        (abs(-T.Accuracy(**CPU)), abs(-J.Accuracy())),
    ]
    for comp, ref in cases:
        eager = comp.clone()
        state = comp.init_state()
        for _ in range(3):
            p, t = rng.rand(32, 4).astype(np.float32), rng.randint(0, 4, 32)
            state = comp.apply_update(state, torch.from_numpy(p), torch.from_numpy(t))
            eager.update(torch.from_numpy(p), torch.from_numpy(t))
            ref.update(jnp.asarray(p), jnp.asarray(t))
        np.testing.assert_allclose(comp.apply_compute(state).numpy(), eager.compute().numpy(), atol=1e-6)
        np.testing.assert_allclose(eager.compute().numpy(), np.asarray(ref.compute()), atol=1e-6)


def test_pure_api_with_an_aliased_operand_advances_the_one_state_twice():
    m = T.Accuracy(**CPU)
    comp = m + m
    eager_m = T.Accuracy(**CPU)
    eager = eager_m + eager_m
    rng = np.random.RandomState(3)
    state = comp.init_state()
    assert set(state) == {"a"}
    for _ in range(2):
        p, t = torch.from_numpy(rng.rand(16, 4).astype(np.float32)), torch.from_numpy(rng.randint(0, 4, 16))
        state = comp.apply_update(state, p, t)
        eager.update(p, t)
    np.testing.assert_allclose(comp.apply_compute(state).numpy(), eager.compute().numpy(), atol=1e-6)


def test_a_compiled_forward_is_refused_with_the_jax_package_error():
    comp, ref = DummyMetric(2) + 1, JDummyMetric(2) + 1
    with pytest.raises(ValueError) as port_err:
        comp.jit_forward()
    with pytest.raises(ValueError) as jax_err:
        ref.jit_forward()
    assert str(port_err.value) == str(jax_err.value)
    assert comp.jit_forward(False) is comp


def test_composition_lives_on_its_children_device():
    assert (DummyMetric(1) + 1).device == torch.device("cpu")
    assert (2 * DummyMetric(1)).device == torch.device("cpu")


# -- AverageMeter (tests/bases/test_average.py) -------------------------------------


def test_average_simple():
    avg = T.AverageMeter(**CPU)
    avg.update(3)
    avg.update(1)
    np.testing.assert_allclose(avg.compute().numpy(), 2.0)


@pytest.mark.parametrize(
    "values, weights, expected",
    [([1.0, 2.0], [3.0, 1.0], 1.25), ([1.0, 2.0, 3.0], None, 2.0), ([4.0, 8.0], 0.5, 6.0)],
)
def test_average_forward_equals_the_jax_package(values, weights, expected):
    avg, ref = T.AverageMeter(**CPU), J.AverageMeter()
    port_args = [torch.tensor(values)] + ([] if weights is None else [torch.as_tensor(weights)])
    jax_args = [jnp.asarray(values)] + ([] if weights is None else [jnp.asarray(weights)])
    got = avg(*port_args)
    np.testing.assert_allclose(got.numpy(), expected)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(*jax_args)), rtol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_average_distributed(world):
    """Each rank's meter, synced by an injected gather that hands back every
    rank's copy of the state it is given."""
    ranks = [T.AverageMeter(**CPU) for _ in range(world)]
    rng = np.random.default_rng(42)
    values = rng.normal(size=(world, 5)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(world, 5)).astype(np.float32)
    for r in range(world):
        ranks[r].update(torch.from_numpy(values[r]), torch.from_numpy(weights[r]))

    def gather(x, group=None):
        name = next(k for k in ("value", "weight") if getattr(ranks[0], k) is x)
        return [getattr(m, name) for m in ranks]

    ranks[0].dist_sync_fn = gather
    expected = (values.astype(np.float64) * weights).sum() / weights.sum()
    np.testing.assert_allclose(ranks[0].compute().numpy(), expected, rtol=1e-6)
