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

The reservoir (``uniform_hash``, ``weighted_priority``,
``bounded_priority_keep``) against ``metrics_tpu/kernels/sketches.py``'s:
the hash bit for bit, the kept rows exactly, the priority within one float32
ulp; with the merge properties of ``tests/kernels/test_sketches.py`` (order
independence, the empty reservoir as identity, whole queries kept across
batches, the gathered merge) and the reservoir's telemetry against the JAX
snapshot.
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


# -- the reservoir ---------------------------------------------------------------------------


def _inverse_hash_id(h: int) -> int:
    """The id whose murmur3 finalizer value is ``h`` (each step inverted)."""
    m = 0xFFFFFFFF
    x = h ^ (h >> 16)
    x = (x * pow(0xC2B2AE35, -1, 1 << 32)) & m
    x = x ^ (x >> 13) ^ (x >> 26)
    x = (x * pow(0x85EBCA6B, -1, 1 << 32)) & m
    x = x ^ (x >> 16)
    return (x - 0x9E3779B9) & m


def _same_bits(got, want):
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))


def test_uniform_hash_is_bit_identical_at_the_edges():
    top = _inverse_hash_id(0xFFFFFFFF)  # hashes to 2^32 - 1, which rounds to 1.0
    edges = np.array([0, 1, -1, 2, 5, 2**31 - 1, -2**31, 2**31, -2**31 - 1, 2**32 - 1, 2**32, 2**32 + 5,
                      -2**63, 2**63 - 1, top, top - 2**32, _inverse_hash_id(0), _inverse_hash_id(1)], np.int64)
    got = TS.uniform_hash(_t(edges))
    _same_bits(got, JS.uniform_hash(jnp.asarray(edges)))
    assert float(got[edges == top][0]) == 1.0 and float(got[-2]) == 0.0
    # the low 32 bits are hashed: 5 and 2^32 + 5 collide, as a cast to uint32 makes them
    assert float(got[4]) == float(got[11])
    for dtype in (np.int32, np.int16, np.uint8):
        small = edges.astype(dtype)
        _same_bits(TS.uniform_hash(_t(small)), JS.uniform_hash(jnp.asarray(small)))


def test_uniform_hash_is_bit_identical_on_a_million_ids():
    rng = np.random.RandomState(40)
    ids = np.concatenate([rng.randint(-2**62, 2**62, 500_000), rng.randint(-2**31, 2**31, 500_000)])
    _same_bits(TS.uniform_hash(_t(ids)), JS.uniform_hash(jnp.asarray(ids)))
    ids32 = ids[500_000:].astype(np.int32)
    _same_bits(TS.uniform_hash(_t(ids32)), JS.uniform_hash(jnp.asarray(ids32)))


def test_weighted_priority_within_one_ulp():
    """The two ``log`` implementations differ by up to one float32 ulp; a
    power-of-two weight divides exactly, so the priority does too. Dividing
    by another weight rounds once more: within two ulps."""
    u = np.array(JS.uniform_hash(jnp.arange(20_000)))
    u[:4] = [0.0, 1e-13, 1.0, 0.5]
    for weight, ulps in ((1.0, 1), (4.0, 1), (np.random.RandomState(41).rand(20_000).astype(np.float32) + 0.1, 2)):
        got = TS.weighted_priority(_t(u), _t(weight) if isinstance(weight, np.ndarray) else weight)
        want = np.asarray(JS.weighted_priority(jnp.asarray(u), weight))
        assert got.dtype == torch.float32
        np.testing.assert_array_max_ulp(got.numpy(), want.astype(np.float32), maxulp=ulps)
    light = TS.weighted_priority(_t(u[:10_000]), 1.0)
    heavy = TS.weighted_priority(_t(u[10_000:]), 4.0)
    assert float((heavy < light).float().mean()) > 0.7


def _keep_both(keys, qids, vals, cap):
    got = TS.bounded_priority_keep(_t(keys), _t(qids), tuple(_t(v) for v in vals), cap)
    want = JS.bounded_priority_keep(jnp.asarray(keys), jnp.asarray(qids), tuple(jnp.asarray(v) for v in vals), cap)
    return got, want


@pytest.mark.parametrize("cap", [1, 7, 64, 500])
def test_bounded_priority_keep_equals_the_jax_package_exactly(cap):
    """Rows of one query share both keys, so arrival order decides among
    them; empty slots (+inf) fall off the end."""
    rng = np.random.RandomState(cap)
    qids = rng.randint(-5, 40, 300).astype(np.int32)
    keys = np.array(JS.uniform_hash(jnp.asarray(qids)))
    keys[rng.rand(300) < 0.2] = np.inf
    vals = (np.arange(300, dtype=np.float32), rng.rand(300).astype(np.float32))
    (k, q, v), (jk, jq, jv) = _keep_both(keys, qids, vals, cap)
    assert k.dtype == torch.float32 and q.dtype == torch.int32
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    for got, want in zip(v, jv):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # within a query (one key), the rows keep their arrival order
    order, finite = v[0].numpy(), np.isfinite(k.numpy())
    for qid in np.unique(q.numpy()):
        assert np.all(np.diff(order[(q.numpy() == qid) & finite]) > 0)


def _reservoir(ids, cap):
    keys = torch.full((cap,), float("inf"))
    qids = torch.zeros((cap,), dtype=torch.int32)
    vals = torch.zeros((cap,))
    new = _t(ids).to(torch.int32)
    k, q, (v,) = TS.bounded_priority_keep(torch.cat([keys, TS.uniform_hash(new)]), torch.cat([qids, new]),
                                          (torch.cat([vals, new.float()]),), cap)
    return k, q, v


def test_reservoir_merge_is_order_independent_with_the_empty_reservoir_as_identity():
    cap = 32
    rng = np.random.RandomState(2)
    a = _reservoir(rng.randint(0, 1000, 40), cap)
    b = _reservoir(rng.randint(1000, 2000, 40), cap)

    def merge(x, y):
        k, q, (v,) = TS.bounded_priority_keep(torch.cat([x[0], y[0]]), torch.cat([x[1], y[1]]),
                                              (torch.cat([x[2], y[2]]),), cap)
        return k, q, v

    for got, want in zip(merge(a, b), merge(b, a)):
        assert torch.equal(got, want)
    empty = (torch.full((cap,), float("inf")), torch.zeros((cap,), dtype=torch.int32), torch.zeros((cap,)))
    for got, want in zip(merge(a, empty), a):
        assert torch.equal(got, want)


def test_reservoir_keeps_whole_queries_across_batches():
    rng = np.random.RandomState(15)
    m = T.RetrievalMAP(sketched=True, sketch_capacity=256, **CPU)
    ref = J.RetrievalMAP(sketched=True, sketch_capacity=256)
    all_q = []
    for _ in range(6):
        q, p, t = rng.randint(0, 120, 300), rng.rand(300).astype(np.float32), rng.randint(0, 2, 300)
        m.update(_t(p), _t(t), indexes=_t(q))
        ref.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(q))
        all_q.append(q)
    with pytest.warns(UserWarning, match="sampled"):
        idx, preds, targ = m._reservoir_rows()
    with pytest.warns(UserWarning, match="sampled"):
        jidx, jpreds, jtarg = ref._reservoir_rows()
    for got, want in ((idx, jidx), (preds, jpreds), (targ, jtarg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q_all = np.concatenate(all_q)
    for qid in np.unique(idx.numpy()):
        assert (idx.numpy() == qid).sum() == (q_all == qid).sum(), f"query {qid} truncated"


def test_gathered_reservoirs_merge_to_the_single_process_value():
    rng = np.random.RandomState(16)
    q, p, t = rng.randint(0, 60, 800), rng.rand(800).astype(np.float32), rng.randint(0, 2, 800)
    shards = []
    for i in range(2):
        m = T.RetrievalMAP(sketched=True, sketch_capacity=1024, **CPU)
        sl = slice(i * 400, (i + 1) * 400)
        m.update(_t(p[sl]), _t(t[sl]), indexes=_t(q[sl]))
        shards.append(m)
    merged = T.RetrievalMAP(sketched=True, sketch_capacity=1024, **CPU)
    merged._update_called = True
    for name in ("res_key", "res_qid", "res_pred", "res_target", "res_overflow"):
        setattr(merged, name, torch.stack([getattr(s, name) for s in shards]))  # as the sync's "cat" leaves it
    merged.res_seen = shards[0].res_seen + shards[1].res_seen
    single = T.RetrievalMAP(sketched=True, sketch_capacity=4096, **CPU)
    single.update(_t(p), _t(t), indexes=_t(q))
    assert float(merged.compute()) == float(single.compute())


def test_reservoir_telemetry_equals_the_jax_snapshot():
    """``sketch_merges`` (one per extra shard at compute) and the
    ``info.sketch`` blob (kind, capacity, rows seen and kept, queries kept,
    rows dropped) after the same calls, on one shard that overflowed and
    on two gathered shards."""
    import metrics_tpu.observability as jobs
    import metrics_tpu_torch.observability as tobs

    rng = np.random.RandomState(17)
    q, p, t = rng.randint(0, 90, 900), rng.rand(900).astype(np.float32), rng.randint(0, 2, 900)
    jobs.reset()
    tobs.reset()
    pairs = []
    for shards in (1, 2):
        made = []
        for pkg, conv, cat in ((T, _t, torch.cat), (J, jnp.asarray, jnp.concatenate)):
            parts = [pkg.RetrievalMAP(sketched=True, sketch_capacity=200, **(CPU if pkg is T else {}))
                     for _ in range(shards)]
            for i, part in enumerate(parts):
                sl = slice(i * 900 // shards, (i + 1) * 900 // shards)
                part.update(conv(p[sl]), conv(t[sl]), indexes=conv(q[sl]))
            m = parts[0]
            if shards > 1:
                m = pkg.RetrievalMAP(sketched=True, sketch_capacity=200, **(CPU if pkg is T else {}))
                m._update_called = True
                for name in ("res_key", "res_qid", "res_pred", "res_target", "res_overflow"):
                    setattr(m, name, cat([getattr(s, name) for s in parts]))
                m.res_seen = parts[0].res_seen + parts[1].res_seen
            with pytest.warns(UserWarning, match="sampled"):
                m.compute()
            made.append(m)
        pairs.append(tuple(made))
    tsnap, jsnap = tobs.snapshot(), jobs.snapshot()
    for port, ref in pairs:
        got, want = tsnap["metrics"][port.telemetry_key], jsnap["metrics"][ref.telemetry_key]
        assert got["info"]["sketch"] == want["info"]["sketch"]
        assert got["info"]["sketch"]["kind"] == "reservoir"
        assert got["counters"].get("sketch_merges", 0) == want["counters"].get("sketch_merges", 0)
    assert tsnap["metrics"][pairs[1][0].telemetry_key]["counters"]["sketch_merges"] == 1
