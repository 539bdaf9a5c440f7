"""The port's grid sketches and tie groups against the JAX package's.

``kernels/sketches.py``'s CDF sketch (``cdf_sketch_update``,
``cdf_sketch_cdf``, ``cdf_sketch_quantile``) and joint rank grid
(``joint_grid_update``, ``spearman_from_grid``), and
``utilities/data.py::tie_group_bounds``, each fed the same seeded numpy
inputs as ``metrics_tpu/kernels/sketches.py``'s and
``metrics_tpu/utilities/data.py``'s functions: counts and indices equal
exactly, float32 values within ``rtol=atol=1e-6``. Out-of-range values clip
into the edge bins and are counted; an empty grid gives NaN on both sides.
``SpearmanCorrcoef(sketched=True)`` is held against the JAX metric (grid and
clipped count exactly, rho within 1e-6), through the compiled step and keyed
per tenant.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import spearmanr

import metrics_tpu as J
import metrics_tpu.kernels.sketches as JS
import metrics_tpu_torch as T
import metrics_tpu_torch.kernels.sketches as TS
from metrics_tpu.utilities.data import tie_group_bounds as j_tie_group_bounds
from metrics_tpu_torch.utilities.data import tie_group_bounds

CPU = {"device": "cpu"}
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _equal(got, want):
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(6))
def test_tie_group_bounds_matches_the_jax_package(seed):
    rng = np.random.RandomState(seed)
    n = [1, 2, 7, 64, 257, 1000][seed]
    key = np.sort(rng.randint(0, max(1, n // 3), n))
    changed = key[1:] != key[:-1]
    start, end = tie_group_bounds(_t(changed))
    jstart, jend = j_tie_group_bounds(jnp.asarray(changed))
    assert start.dtype == torch.int64 and end.dtype == torch.int64
    _equal(start, jstart)
    _equal(end, jend)
    # every position lies inside its group, whose key is constant
    idx = np.arange(n)
    assert np.all(start.numpy() <= idx) and np.all(idx <= end.numpy())
    assert np.all(key[start.numpy()] == key) and np.all(key[end.numpy()] == key)


# -- the joint rank grid ---------------------------------------------------------------


@pytest.mark.parametrize("bins", [(8, 8), (16, 5), (512, 512)])
@pytest.mark.parametrize("ranges", [((0.0, 1.0), (0.0, 1.0)), ((-0.5, 0.5), (0.2, 2.0))])
def test_joint_grid_update_matches_the_jax_package(bins, ranges):
    rng = np.random.RandomState(sum(bins))
    grid = np.zeros(bins, np.float32)
    jgrid = jnp.asarray(grid)
    tgrid = _t(grid)
    total_clipped = 0.0
    for _ in range(3):
        x = (rng.rand(300) * 1.4 - 0.2).astype(np.float32)  # some out of range on each side
        y = (x * 1.5 + 0.3 * rng.randn(300)).astype(np.float32)
        x[:3] = [np.nan, np.inf, -np.inf]
        tgrid, clipped = TS.joint_grid_update(tgrid, _t(x), _t(y), *ranges)
        jgrid, jclipped = JS.joint_grid_update(jgrid, jnp.asarray(x), jnp.asarray(y), *ranges)
        assert tgrid.dtype == torch.float32 and clipped.dtype == torch.float32
        _equal(tgrid, jgrid)
        _equal(clipped, jclipped)
        total_clipped += float(clipped)
    assert float(tgrid.sum()) == 900.0  # every pair lands in a bin, clipped or not
    assert total_clipped > 0
    got = TS.spearman_from_grid(tgrid)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(JS.spearman_from_grid(jgrid)), **TOL)


def test_spearman_from_grid_of_an_empty_grid_is_nan():
    got = TS.spearman_from_grid(torch.zeros((16, 16)))
    want = JS.spearman_from_grid(jnp.zeros((16, 16)))
    assert bool(torch.isnan(got)) and bool(jnp.isnan(want))


def test_spearman_from_grid_is_the_rho_of_the_discretized_stream():
    rng = np.random.RandomState(5)
    x = rng.rand(2000).astype(np.float32)
    y = (x + 0.2 * rng.randn(2000)).astype(np.float32)
    grid, _ = TS.joint_grid_update(torch.zeros((64, 64)), _t(x), _t(y), (0.0, 1.0), (-1.0, 2.0))
    ix = TS.grid_index(_t(x), 64, 0.0, 1.0).numpy()
    iy = TS.grid_index(_t(y), 64, -1.0, 2.0).numpy()
    np.testing.assert_allclose(float(TS.spearman_from_grid(grid)), spearmanr(ix, iy).statistic, atol=1e-5)


# -- the CDF sketch ---------------------------------------------------------------------


@pytest.mark.parametrize("num_bins, lo, hi", [(16, 0.0, 1.0), (100, -2.0, 3.0), (1024, 0.0, 10.0)])
def test_cdf_sketch_matches_the_jax_package(num_bins, lo, hi):
    rng = np.random.RandomState(num_bins)
    counts = np.zeros(num_bins, np.float32)
    tcounts, jcounts = _t(counts), jnp.asarray(counts)
    for _ in range(3):
        x = (lo + (hi - lo) * (rng.rand(500) * 1.2 - 0.1)).astype(np.float32)  # out-of-range values clip
        tcounts = TS.cdf_sketch_update(tcounts, _t(x), lo, hi)
        jcounts = JS.cdf_sketch_update(jcounts, jnp.asarray(x), lo, hi)
        _equal(tcounts, jcounts)
    assert tcounts.dtype == torch.float32 and float(tcounts.sum()) == 1500.0
    v = np.linspace(lo - 1, hi + 1, 37).astype(np.float32)
    got = TS.cdf_sketch_cdf(tcounts, _t(v), lo, hi)
    np.testing.assert_allclose(got.numpy(), np.asarray(JS.cdf_sketch_cdf(jcounts, jnp.asarray(v), lo, hi)), **TOL)
    for q in (0.5, [0.0, 0.01, 0.25, 0.5, 0.99, 1.0]):
        got = TS.cdf_sketch_quantile(tcounts, q, lo, hi)
        want = JS.cdf_sketch_quantile(jcounts, q, lo, hi)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_cdf_sketch_of_an_empty_sketch_matches_the_jax_package():
    counts = np.zeros(8, np.float32)
    np.testing.assert_allclose(TS.cdf_sketch_quantile(_t(counts), [0.1, 0.9], 0.0, 1.0).numpy(),
                               np.asarray(JS.cdf_sketch_quantile(jnp.asarray(counts), jnp.asarray([0.1, 0.9]),
                                                                 0.0, 1.0)))
    v = np.asarray([0.3], np.float32)
    _equal(TS.cdf_sketch_cdf(_t(counts), _t(v), 0.0, 1.0), JS.cdf_sketch_cdf(jnp.asarray(counts), jnp.asarray(v),
                                                                              0.0, 1.0))


# -- SpearmanCorrcoef(sketched=True) --------------------------------------------------------


def _stream(seed, batches=5, n=200):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        p = rng.randn(n).astype(np.float32)
        out.append((p, (p * 0.7 + 0.5 * rng.randn(n)).astype(np.float32)))
    return out


@pytest.mark.parametrize("value_range", [(-3.0, 3.0), ((-2.0, 2.0), (-2.5, 2.5))])
def test_sketched_spearman_matches_the_jax_metric(value_range):
    port = T.SpearmanCorrcoef(sketched=True, num_bins=128, value_range=value_range, **CPU)
    ref = J.SpearmanCorrcoef(sketched=True, num_bins=128, value_range=value_range)
    batches = _stream(3)
    for p, t in batches:
        np.testing.assert_allclose(port(_t(p), _t(t)).numpy(), np.asarray(ref(jnp.asarray(p), jnp.asarray(t))), **TOL)
    assert port.joint_grid.dtype == torch.float32 and port.sketch_clipped.dtype == torch.float32
    _equal(port.joint_grid, ref.joint_grid)
    _equal(port.sketch_clipped, ref.sketch_clipped)
    got = port.compute()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.compute()), **TOL)
    exact = spearmanr(np.concatenate([p for p, _ in batches]), np.concatenate([t for _, t in batches])).statistic
    assert abs(float(got) - exact) < 1e-2  # the JAX package's stated bound


def test_sketched_spearman_compiled_and_keyed():
    batches = _stream(4, batches=4, n=64)
    eager = T.SpearmanCorrcoef(sketched=True, num_bins=64, value_range=(-3.0, 3.0), compute_on_step=False, **CPU)
    compiled = T.SpearmanCorrcoef(sketched=True, num_bins=64, value_range=(-3.0, 3.0), compute_on_step=False,
                                  **CPU).jit_forward()
    for p, t in batches:
        eager(_t(p), _t(t))
        compiled(_t(p), _t(t))
    assert compiled._jit_forward_fn.cache_info()["entries"] == 1
    _equal(compiled.joint_grid, eager.joint_grid.numpy())

    port = T.SpearmanCorrcoef(sketched=True, num_bins=32, value_range=(-3.0, 3.0), **CPU).keyed(3)
    ref = J.SpearmanCorrcoef(sketched=True, num_bins=32, value_range=(-3.0, 3.0)).keyed(3)
    rng = np.random.RandomState(8)
    for p, t in batches:
        ids = rng.randint(0, 3, len(p))
        port.update(_t(ids), _t(p), _t(t))
        ref.update(jnp.asarray(ids), jnp.asarray(p), jnp.asarray(t))
    _equal(port.joint_grid, ref.joint_grid)
    _equal(port.sketch_clipped, ref.sketch_clipped)
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), **TOL)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"sketched": True},
        {"sketched": True, "value_range": (1.0, 0.0)},
        {"sketched": True, "value_range": (0.0, 1.0), "num_bins": 1},
        {"sketched": True, "value_range": (0.0, 1.0), "capacity": 10},
        {"capacity": 0},
        {"capacity": 8, "overflow": "explode"},
    ],
)
def test_sketched_and_capacity_arguments_raise_as_the_jax_package_does(kwargs):
    with pytest.raises(ValueError) as port_err:
        T.SpearmanCorrcoef(**kwargs, **CPU)
    with pytest.raises(ValueError) as jax_err:
        J.SpearmanCorrcoef(**kwargs)
    assert str(port_err.value) == str(jax_err.value)
