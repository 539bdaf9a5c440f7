"""The port's ``BootStrapper`` against the JAX package's.

Mirrors ``tests/wrappers/test_bootstrapping.py`` case by case. The two
packages draw from different generators (``torch.Generator`` against JAX's
PRNG), so where values are compared, ``_bootstrap_sampler`` is monkeypatched
in both packages to hand out the same numpy index vectors (the JAX package's
files stay as they are); each child's value must then equal the JAX
package's and sklearn on its recorded stream, and the statistics numpy's
(within 1e-6). The pure path is held against the port's eager path fed the
same ``(num_bootstraps, size)`` index matrix, and against the JAX package's
pure path fed the same matrices through its patched key splits and
sampler. The padding contract of the
fixed-length Poisson resample has its port twin
(:func:`test_fixed_length_repeat_matches_jnp_repeat`): equal to
``jnp.repeat(..., total_repeat_length=)`` on seeded counts whose totals fall
short of, equal and pass the length. The stacked-state sync over a process
group is in ``tests/test_torch_sync_gloo.py`` (two gloo ranks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import precision_score, recall_score

import metrics_tpu as J
import metrics_tpu.wrappers.bootstrapping as jboot
import metrics_tpu_torch as T
import metrics_tpu_torch.wrappers.bootstrapping as tboot
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.wrappers import BootStrapper

CPU = {"device": "cpu"}
TOL = dict(rtol=1e-6, atol=1e-6)

_rng = np.random.RandomState(9)
_preds = _rng.randint(0, 10, (10, 32))
_target = _rng.randint(0, 10, (10, 32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# -- the sampler ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampling_strategy", ["poisson", "multinomial"])
def test_bootstrap_sampler(sampling_strategy):
    """New samples consist only of old samples, some repeated, some dropped."""
    old_samples = _rng.randn(20, 2)
    idx = tboot._bootstrap_sampler(20, _gen(0), sampling_strategy=sampling_strategy).numpy()
    assert ((0 <= idx) & (idx < 20)).all()
    new_samples = old_samples[idx]
    for ns in new_samples:
        assert any((ns == os).all() for os in old_samples)
    counts = np.bincount(idx, minlength=20)
    assert (counts > 1).any(), "no sample was drawn twice"
    assert (counts == 0).any(), "every sample was drawn — not a resample"


@pytest.mark.parametrize("pure", [False, True])
@pytest.mark.parametrize("sampling_strategy", ["poisson", "multinomial"])
def test_bootstrap_sampler_reproducible(sampling_strategy, pure):
    def draw():
        if pure:
            return tboot._bootstrap_indices(3, 16, _gen(5), sampling_strategy)
        return tboot._bootstrap_sampler(16, _gen(5), sampling_strategy)

    assert torch.equal(draw(), draw())


def test_bootstrap_sampler_rejects_an_unknown_strategy():
    with pytest.raises(ValueError, match="Unknown sampling strategy"):
        tboot._bootstrap_sampler(4, _gen(), "jackknife")


def test_fixed_length_repeat_pins_the_jnp_repeat_contract():
    """The port twin of ``test_jnp_repeat_padding_contract``: a short total
    is padded with the LAST input element, even when its count is 0."""
    out = tboot._fixed_length_repeat(torch.tensor([3, 5]), torch.tensor([1, 1]), 4)
    np.testing.assert_array_equal(out.numpy(), [3, 5, 5, 5])
    out = tboot._fixed_length_repeat(torch.tensor([7, 2]), torch.tensor([2, 0]), 4)
    np.testing.assert_array_equal(out.numpy(), [7, 7, 2, 2])


def test_fixed_length_repeat_matches_jnp_repeat():
    rng = np.random.RandomState(12)
    totals = set()
    for _ in range(200):
        size = rng.randint(1, 12)
        counts = rng.poisson(1.0, size)
        values = rng.permutation(size)
        got = tboot._fixed_length_repeat(_t(values), _t(counts), size)
        want = jnp.repeat(jnp.asarray(values), jnp.asarray(counts), total_repeat_length=size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        totals.add(int(np.sign(counts.sum() - size)))
    assert totals == {-1, 0, 1}
    # rows of a matrix take the contract row by row
    counts = rng.poisson(1.0, (5, 9))
    values = np.stack([rng.permutation(9) for _ in range(5)])
    got = tboot._fixed_length_repeat(_t(values), _t(counts), 9)
    for row in range(5):
        want = jnp.repeat(jnp.asarray(values[row]), jnp.asarray(counts[row]), total_repeat_length=9)
        np.testing.assert_array_equal(got[row].numpy(), np.asarray(want))


def test_fixed_length_poisson_sampler_statistics():
    """The fixed-length Poisson resample is uniform over rows."""
    size, n_draws = 64, 200
    counts = np.zeros(size)
    gen = _gen(1)
    for _ in range(n_draws):  # one row a draw
        idx = tboot._bootstrap_indices(1, size, gen, "poisson")[0].numpy()
        assert idx.shape == (size,) and idx.min() >= 0 and idx.max() < size
        counts += np.bincount(idx, minlength=size)
    per_row = counts / n_draws
    np.testing.assert_allclose(per_row.mean(), 1.0, atol=0.05)
    assert per_row.std() < 0.3
    matrix = tboot._bootstrap_indices(n_draws, size, _gen(2), "poisson").numpy()  # all rows in one draw
    assert matrix.shape == (n_draws, size)
    per_row = np.bincount(matrix.ravel(), minlength=size) / n_draws
    np.testing.assert_allclose(per_row.mean(), 1.0, atol=0.05)
    assert per_row.std() < 0.3


# -- the eager path against the JAX package, on shared indices ------------------------------


class _SharedIndices:
    """Hands out the same seeded numpy index vectors to both packages'
    patched samplers, one per call, and records them."""

    def __init__(self, seed, strategy):
        self.rng = np.random.RandomState(seed)
        self.strategy = strategy
        self.draws = {"jax": [], "torch": []}

    def _draw(self, pkg, size):
        i = len(self.draws[pkg])
        other = self.draws["torch" if pkg == "jax" else "jax"]
        if i < len(other):
            idx = other[i]
        elif self.strategy == "poisson":
            idx = np.repeat(np.arange(size), self.rng.poisson(1.0, size))
        else:
            idx = self.rng.randint(0, size, size)
        self.draws[pkg].append(idx)
        return idx

    def patch(self, monkeypatch):
        monkeypatch.setattr(jboot, "_bootstrap_sampler",
                            lambda size, key, sampling_strategy="poisson", fixed_length=False:
                            jnp.asarray(self._draw("jax", size)))
        monkeypatch.setattr(tboot, "_bootstrap_sampler",
                            lambda size, generator, sampling_strategy="poisson":
                            torch.from_numpy(self._draw("torch", size)))


@pytest.mark.parametrize("sampling_strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("metric, sk_metric", [("Precision", precision_score), ("Recall", recall_score)])
def test_bootstrap(monkeypatch, sampling_strategy, metric, sk_metric):
    shared = _SharedIndices(11, sampling_strategy)
    shared.patch(monkeypatch)
    kw = dict(num_bootstraps=10, mean=True, std=True, raw=True, sampling_strategy=sampling_strategy, seed=11)
    jb = J.BootStrapper(getattr(J, metric)(average="micro"), quantile=jnp.asarray([0.05, 0.95]), **kw)
    tb = BootStrapper(getattr(T, metric)(average="micro", **CPU), quantile=torch.tensor([0.05, 0.95]), **kw)
    for p, t in zip(_preds, _target):
        jb.update(jnp.asarray(p), jnp.asarray(t))
        tb.update(_t(p), _t(t))
    assert [a.tolist() for a in shared.draws["jax"]] == [a.tolist() for a in shared.draws["torch"]]

    streams = [shared.draws["torch"][b::10] for b in range(10)]
    sk_scores = [
        sk_metric(np.concatenate([t[i] for t, i in zip(_target, idx)]),
                  np.concatenate([p[i] for p, i in zip(_preds, idx)]), average="micro")
        for idx in streams
    ]
    got, want = tb.compute(), jb.compute()
    assert sorted(got) == sorted(want) == ["mean", "quantile", "raw", "std"]
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
    np.testing.assert_allclose(got["raw"].numpy(), sk_scores, **TOL)
    np.testing.assert_allclose(got["mean"].numpy(), np.mean(sk_scores), **TOL)
    np.testing.assert_allclose(got["std"].numpy(), np.std(sk_scores, ddof=1), **TOL)
    np.testing.assert_allclose(got["quantile"].numpy(), np.quantile(sk_scores, [0.05, 0.95]), **TOL)


def test_bootstrap_reset_and_invalid_args():
    strapper = BootStrapper(T.Precision(average="micro", **CPU), num_bootstraps=4)
    strapper.update(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 1, 0, 1]))
    strapper.reset()
    for child in strapper.metrics:
        assert float(child.tp) == 0.0

    with pytest.raises(ValueError, match="base metric"):
        BootStrapper(lambda x: x)
    with pytest.raises(ValueError, match="sampling_strategy"):
        BootStrapper(T.Precision(**CPU), sampling_strategy="jackknife")


def test_eager_poisson_reads_one_total_per_child_per_update():
    was = TELEMETRY.enabled
    TELEMETRY.enable()
    try:
        b = BootStrapper(T.Accuracy(**CPU), num_bootstraps=5)
        for p, t in zip(_preds[:3], _target[:3]):
            b.update(_t(p), _t(t))
        assert TELEMETRY.counter(b.telemetry_key, "bootstrap_host_reads") == 15
        m = BootStrapper(T.Accuracy(**CPU), num_bootstraps=5, sampling_strategy="multinomial")
        m.update(_t(_preds[0]), _t(_target[0]))
        assert TELEMETRY.counter(m.telemetry_key, "bootstrap_host_reads") == 0
    finally:
        if not was:
            TELEMETRY.disable()


def test_generators_live_on_the_metric_device_and_default_to_the_card():
    b = BootStrapper(T.Accuracy(**CPU), num_bootstraps=2)
    assert b.device.type == "cpu" and b._generator.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BootStrapper(T.Accuracy(**CPU), device="cuda")


# -- the pure path -------------------------------------------------------------------------


def _wrapper(**kwargs):
    kwargs.setdefault("sampling_strategy", "multinomial")
    return BootStrapper(T.Accuracy(**CPU), num_bootstraps=20, seed=3, raw=True, **kwargs)


def _acc_inputs(seed, n=64):
    rng = np.random.RandomState(seed)
    return _t(rng.rand(n, 4).astype(np.float32)), _t(rng.randint(0, 4, n))


@pytest.mark.parametrize("sampling_strategy", ["multinomial", "poisson"])
def test_pure_path_equals_the_eager_path_on_the_same_indices(monkeypatch, sampling_strategy):
    steps = [_acc_inputs(s) for s in range(5)]
    matrices = []
    real = tboot._bootstrap_indices

    def recording(num, size, generator, strategy):
        out = real(num, size, generator, strategy)
        matrices.append(out)
        return out

    monkeypatch.setattr(tboot, "_bootstrap_indices", recording)
    b = _wrapper(sampling_strategy=sampling_strategy)
    state = b.init_state()
    for p, t in steps:
        state = b.apply_update(state, p, t)
    assert int(state["step"]) == 5 and state["seed"].device.type == "cpu"
    pure = b.apply_compute(state)

    rows = iter(row for matrix in matrices for row in matrix)
    monkeypatch.setattr(tboot, "_bootstrap_sampler", lambda *a, **k: next(rows))
    eager = _wrapper(sampling_strategy=sampling_strategy)
    for p, t in steps:
        eager.update(p, t)
    got = eager.compute()
    for key in ("raw", "mean", "std"):
        np.testing.assert_allclose(pure[key].numpy(), got[key].numpy(), rtol=0, atol=0)


_PURE_CHILDREN = [
    ("Accuracy", {"average": "macro", "num_classes": 4}),
    ("F1", {"average": "macro", "num_classes": 4}),
    ("Accuracy", {}),
]


def _pure_both(monkeypatch, jb, tb, steps, sampling_strategy):
    """Both packages' pure ``init_state``/``apply_update``/``apply_compute``
    on the same ``(num_bootstraps, size)`` index matrices: ``(port stats,
    JAX stats, port state, JAX state)``. The JAX side's keys are replaced
    by ``(step, child)`` pairs: its ``jax.random.split`` is patched to hand
    them out (the wrapper splits the state's key once a step, then the
    sub-key once per child), and its ``_bootstrap_sampler`` to read row
    ``child`` of matrix ``step``."""
    import jax

    size = steps[0][0].shape[0]
    gen = _gen(7)
    matrices = [tboot._bootstrap_indices(tb.num_bootstraps, size, gen, sampling_strategy) for _ in steps]
    stacked = jnp.asarray(torch.stack(matrices).numpy())

    def split(key, num=2):
        if num == 2:  # (the next state's key, this step's sub-key)
            return jnp.stack([key + jnp.asarray([1, 0], jnp.uint32), key])
        return jnp.stack([jnp.full((num,), key[0], jnp.uint32), jnp.arange(num, dtype=jnp.uint32)], axis=1)

    monkeypatch.setattr(jax.random, "split", split)
    monkeypatch.setattr(jboot, "_bootstrap_sampler", lambda size, key, **kw: stacked[key[0], key[1]])
    replay = iter(matrices)
    monkeypatch.setattr(tboot, "_bootstrap_indices", lambda *a, **k: next(replay))
    jstate = dict(jb.init_state(), key=jnp.zeros(2, jnp.uint32))
    tstate = tb.init_state()
    for step in steps:
        jstate = jb.apply_update(jstate, *(jnp.asarray(x.numpy()) for x in step))
        tstate = tb.apply_update(tstate, *step)
    assert int(jstate["key"][0]) == int(tstate["step"]) == len(steps)
    return tb.apply_compute(tstate), jb.apply_compute(jstate), tstate, jstate


@pytest.mark.parametrize("sampling_strategy", ["multinomial", "poisson"])
@pytest.mark.parametrize("metric, metric_kw", _PURE_CHILDREN)
def test_pure_path_equals_the_jax_pure_path_on_the_same_index_matrices(monkeypatch, sampling_strategy, metric,
                                                                       metric_kw):
    """Both packages' pure paths on the same index matrices
    (:func:`_pure_both`). The port's macro children count through one B1
    dispatch a step for the whole stack."""
    from metrics_tpu_torch.kernels import _common

    steps = [_acc_inputs(20 + s) for s in range(4)]
    kw = dict(num_bootstraps=6, raw=True, sampling_strategy=sampling_strategy, seed=3)
    jb = J.BootStrapper(getattr(J, metric)(**metric_kw), quantile=jnp.asarray([0.1, 0.9]), **kw)
    tb = BootStrapper(getattr(T, metric)(**metric_kw, **CPU), quantile=torch.tensor([0.1, 0.9]), **kw)
    _common.reset_dispatch_counters()
    got, want, _, _ = _pure_both(monkeypatch, jb, tb, steps, sampling_strategy)
    assert _common.dispatch_count("stat_scores_counts", "torch") == (len(steps) if metric_kw else 0)
    assert sorted(got) == sorted(want) == ["mean", "quantile", "raw", "std"]
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
    assert float(got["std"]) > 0


_TOP_K_CHILDREN = [
    ("Accuracy", {}), ("Precision", {"average": "macro"}), ("Recall", {"average": "micro"}),
    ("F1", {"average": "macro"}), ("FBeta", {"average": "weighted", "beta": 0.5}),
    ("Specificity", {"average": "macro"}), ("StatScores", {"reduce": "macro"}),
]


@pytest.mark.parametrize("metric, metric_kw", _TOP_K_CHILDREN)
def test_pure_path_of_a_top_k_child_equals_the_jax_pure_path(monkeypatch, metric, metric_kw):
    """A ``top_k=2`` child on probabilities under the pure path's vmap: the
    top-k mask is an out-of-place scatter, which ``torch.func.vmap``
    batches (an in-place ``scatter_`` into a fresh tensor raised)."""
    steps = [_acc_inputs(40 + s) for s in range(3)]
    kw = dict(top_k=2, num_classes=4, **metric_kw)
    boot_kw = dict(num_bootstraps=5, raw=True, sampling_strategy="multinomial", seed=4)
    jb = J.BootStrapper(getattr(J, metric)(**kw), **boot_kw)
    tb = BootStrapper(getattr(T, metric)(**kw, **CPU), **boot_kw)
    got, want, _, _ = _pure_both(monkeypatch, jb, tb, steps, "multinomial")
    for key in ("raw", "mean", "std"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
    assert got["mean"].dtype == got["std"].dtype == torch.float32


def test_pure_bootstrap_of_capacity_spearman_equals_the_jax_pure_path(monkeypatch):
    """``apply_compute`` of ``SpearmanCorrcoef(capacity=N)`` ranks each
    child's buffer under the vmap: the ranks are un-permuted by an
    out-of-place scatter (an in-place one raised)."""
    rng = np.random.RandomState(12)
    steps = []
    for _ in range(3):
        x = rng.randn(40).astype(np.float32)
        steps.append((_t(x), _t((x + 0.5 * rng.randn(40)).astype(np.float32))))
    kw = dict(num_bootstraps=4, raw=True, sampling_strategy="multinomial", seed=2)
    jb = J.BootStrapper(J.SpearmanCorrcoef(capacity=256), **kw)
    tb = BootStrapper(T.SpearmanCorrcoef(capacity=256, **CPU), **kw)
    got, want, _, _ = _pure_both(monkeypatch, jb, tb, steps, "multinomial")
    for key in ("raw", "mean", "std"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-6)
    assert float(got["mean"]) > 0.5


_INTEGER_CHILDREN = [("ConfusionMatrix", {"num_classes": 4}), ("StatScores", {"num_classes": 4, "reduce": "macro"})]


@pytest.mark.parametrize("metric, metric_kw", _INTEGER_CHILDREN)
def test_statistics_of_integer_values_are_float32_as_in_the_jax_package(monkeypatch, metric, metric_kw):
    """A child that computes integer counts: mean, std and quantiles in
    float32 (``torch.mean``/``std`` refuse integers, and the quantile's q
    is built in the float dtype), as the JAX package's (float32 from int32
    counts, x64 or not), equal within float32 rounding."""
    rng = np.random.RandomState(2)
    batches = [(_t(rng.randint(0, 4, 96)), _t(rng.randint(0, 4, 96))) for _ in range(2)]
    shared = _SharedIndices(13, "poisson")
    shared.patch(monkeypatch)
    kw = dict(num_bootstraps=3, raw=True, seed=1)
    jb = J.BootStrapper(getattr(J, metric)(**metric_kw), quantile=jnp.asarray([0.05, 0.95]), **kw)
    tb = BootStrapper(getattr(T, metric)(**metric_kw, **CPU), quantile=torch.tensor([0.05, 0.95]), **kw)
    for p, t in batches:
        jb.update(jnp.asarray(p.numpy()), jnp.asarray(t.numpy()))
        tb.update(p, t)
    got, want = tb.compute(), jb.compute()
    assert not got["raw"].is_floating_point()
    for key in ("mean", "std", "quantile"):
        assert got[key].dtype == torch.float32 and np.asarray(want[key]).dtype == np.float32, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(got["raw"].numpy(), np.asarray(want["raw"]))


@pytest.mark.parametrize("metric, metric_kw", _INTEGER_CHILDREN)
def test_pure_statistics_of_integer_values_are_float32_as_in_the_jax_package(monkeypatch, metric, metric_kw):
    # probabilities: the JAX package's traced canonicalization needs no num_classes for them
    steps = [_acc_inputs(60 + s) for s in range(3)]
    kw = dict(num_bootstraps=4, raw=True, sampling_strategy="poisson", seed=6)
    jb = J.BootStrapper(getattr(J, metric)(**metric_kw), quantile=jnp.asarray([0.1, 0.9]), **kw)
    tb = BootStrapper(getattr(T, metric)(**metric_kw, **CPU), quantile=torch.tensor([0.1, 0.9]), **kw)
    got, want, _, _ = _pure_both(monkeypatch, jb, tb, steps, "poisson")
    for key in ("mean", "std", "quantile"):
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(got["raw"].numpy(), np.asarray(want["raw"]))


def test_pure_path_sane_stats():
    b = _wrapper()
    state = b.init_state()
    full = T.Accuracy(**CPU)
    for s in range(5):
        p, t = _acc_inputs(s)
        state = b.apply_update(state, p, t)
        full.update(p, t)
    out = b.apply_compute(state)
    assert out["raw"].shape == (20,)
    np.testing.assert_allclose(float(out["mean"]), float(full.compute()), atol=0.08)
    assert float(out["std"]) > 0


def test_deterministic_given_state():
    b = _wrapper()
    p, t = _acc_inputs(1, 48)
    r1 = b.apply_compute(b.apply_update(b.init_state(), p, t))["raw"]
    r2 = b.apply_compute(b.apply_update(b.init_state(), p, t))["raw"]
    assert torch.equal(r1, r2)


def test_poisson_pure_path_fixed_length():
    b = _wrapper(sampling_strategy="poisson")
    p, t = _acc_inputs(5, 256)
    out = b.apply_compute(b.apply_update(b.init_state(), p, t), process_group=None)
    full = T.Accuracy(**CPU)
    full.update(p, t)
    assert out["raw"].shape == (20,)
    np.testing.assert_allclose(float(out["mean"]), float(full.compute()), atol=0.08)
    assert float(out["std"]) > 0


def test_pure_key_stream_independent_of_eager_updates():
    p, t = _acc_inputs(6, 48)
    b1 = _wrapper()
    r1 = b1.apply_compute(b1.apply_update(b1.init_state(), p, t))["raw"]
    b2 = _wrapper()
    b2.update(p, t)  # advances the eager generator
    r2 = b2.apply_compute(b2.apply_update(b2.init_state(), p, t))["raw"]
    assert torch.equal(r1, r2)
    # the second step draws anew: its resamples are not the first step's
    s = b1.apply_update(b1.apply_update(b1.init_state(), p, t), p, t)
    assert not torch.equal(b1.apply_compute(s)["raw"], r1)


def test_bootstrap_names_are_exported_as_the_jax_package_exports_them():
    assert hasattr(J, "BootStrapper") and hasattr(T, "BootStrapper")
    assert T.BootStrapper is BootStrapper


def test_forward_keeps_only_the_last_batch_as_the_jax_package_does():
    """A reference fault the port mirrors: the wrapper registers no state,
    so the double-update forward resets the children and restores nothing;
    after three forwards each child holds the last batch alone, in both
    packages (``metrics_tpu/metric.py::_forward_double_update``)."""
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 4, 32), rng.randint(0, 4, 32)) for _ in range(3)]
    kw = dict(num_bootstraps=4, sampling_strategy="multinomial", raw=True)
    jb = J.BootStrapper(J.Accuracy(), **kw)
    tb = BootStrapper(T.Accuracy(**CPU), **kw)
    for p, t in batches:
        jb(jnp.asarray(p), jnp.asarray(t))
        tb(_t(p), _t(t))
    for jm, tm in zip(jb.metrics, tb.metrics):
        assert int(jm.tp) + int(jm.fp) == int(tm.tp) + int(tm.fp) == 32
