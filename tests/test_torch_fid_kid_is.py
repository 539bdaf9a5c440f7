"""The port's FID, KID, IS and InceptionV3 against the JAX package's.

Mirrors ``tests/image/test_fid_kid_is.py`` case by case and
``tests/image/test_inception_goldens.py``: the same seeded numpy features or
images go through the ``metrics_tpu`` object and its ``metrics_tpu_torch``
counterpart (``device="cpu"``, custom feature callables), and the square
roots through scipy. Both FIDs compute in float64 (the JAX package under the
tests' x64), so FID values agree within ``rtol=1e-6``; the eigh form is held
at d = 64, n = 200, and the Newton–Schulz form at d = 512, n = 600, where
``"auto"`` picks it.

The random draws differ between the packages (a ``torch.Generator`` against
JAX's PRNG), so KID is compared with ``subset_size`` equal to n (every
subset the whole set) and IS with ``splits=1`` (the shuffle changes
nothing).

InceptionV3: the JAX package's Flax net with its ``allow_random_weights``
variables is carried across by ``flax_variables_to_state_dict``; every tap
then agrees with the Flax extractor within 1e-4 relative (to each tap's
largest magnitude) at 299 x 299, upsampled from 32 and downsampled from 320
(the antialiasing of ``jax.image.resize``). The port's net also reproduces the
committed goldens (``tests/image/golden/inception_goldens.npz``) from
``tests/helpers/inception_goldens.py::numpy_seeded_state_dict``.
"""
import os
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.special
import torch

import metrics_tpu as J
import metrics_tpu.image.fid as jfid
import metrics_tpu.image.inception_net as jnet
import metrics_tpu.image.kid as jkid
import metrics_tpu_torch as T
import metrics_tpu_torch.image.fid as tfid
import metrics_tpu_torch.image.inception_net as tnet
import metrics_tpu_torch.image.kid as tkid
from metrics_tpu_torch.utilities.data import trace_scope
from tests.helpers.inception_goldens import GOLDEN_VERSION, TAPS, golden_images, numpy_seeded_state_dict, torch_taps
from tests.test_torch_distributed import _run_ranks

CPU = {"device": "cpu"}
F64 = dict(rtol=1e-6, atol=1e-8)
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "image", "golden", "inception_goldens.npz")

_rng = np.random.RandomState(11)


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_psd(dim, scale=1.0):
    a = _rng.randn(dim, dim)
    return (a @ a.T / dim + np.eye(dim) * 0.1) * scale


def _flat_features(imgs, dim=16):
    return imgs.reshape(imgs.shape[0], -1)[:, :dim]


def _np_fid(real, fake):
    mu1, mu2 = real.mean(0), fake.mean(0)
    cov1 = np.cov(real, rowvar=False)
    cov2 = np.cov(fake, rowvar=False)
    covmean = scipy.linalg.sqrtm(cov1 @ cov2)
    return ((mu1 - mu2) ** 2).sum() + np.trace(cov1 + cov2 - 2 * covmean.real)


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


def _pair(cls, **kw):
    """The JAX metric and its port twin built with the same arguments."""
    return _quiet(lambda: (getattr(J, cls)(**kw), getattr(T, cls)(**kw, **CPU)))


def _feed(pair, batches):
    jm, tm = pair
    for args, kwargs in batches:
        jm.update(*[jnp.asarray(a) for a in args], **kwargs)
        tm.update(*[_t(a) for a in args], **kwargs)
    return jm, tm


# -- square roots --------------------------------------------------------------------------


class TestSqrtm:
    @pytest.mark.parametrize("dim", [4, 32])
    def test_sqrtm_psd_vs_scipy_and_jax(self, dim):
        mat = _random_psd(dim)
        got = tfid.sqrtm_psd(_t(mat))
        np.testing.assert_allclose(got.numpy(), scipy.linalg.sqrtm(mat).real, atol=1e-8)
        np.testing.assert_allclose(got.numpy(), np.asarray(jfid.sqrtm_psd(jnp.asarray(mat))), atol=1e-10)

    def test_sqrtm_newton_schulz_vs_scipy_and_jax(self):
        mat = _random_psd(16)
        got = tfid.sqrtm_newton_schulz(_t(mat))
        np.testing.assert_allclose(got.numpy(), scipy.linalg.sqrtm(mat).real, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(jfid.sqrtm_newton_schulz(jnp.asarray(mat))), atol=1e-10)

    def test_sqrtm_differentiable(self):
        mat = torch.tensor(_random_psd(6), requires_grad=True)
        (grad,) = torch.autograd.grad(torch.trace(tfid.sqrtm_psd(mat)), mat)
        want = jax.grad(lambda m: jnp.trace(jfid.sqrtm_psd(m)))(jnp.asarray(mat.detach().numpy()))
        assert bool(torch.isfinite(grad).all())
        np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)

    def test_sqrtm_newton_schulz_ill_conditioned(self):
        rng = np.random.RandomState(5)
        d = 192
        feats = (rng.randn(2000, d) * np.exp(-np.arange(d) / 30.0)).astype(np.float32)
        cov = np.cov(feats.T).astype(np.float32)
        expected = scipy.linalg.sqrtm(cov.astype(np.float64)).real
        got = tfid.sqrtm_newton_schulz(_t(cov)).numpy()
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(np.trace(got), np.trace(expected), rtol=1e-4)


# -- FID -------------------------------------------------------------------------------------


class TestFID:
    def test_fid_vs_numpy_and_jax(self):
        real = _rng.randn(64, 12)
        fake = _rng.randn(64, 12) + 0.5
        args = (real.mean(0), np.cov(real, rowvar=False), fake.mean(0), np.cov(fake, rowvar=False))
        got = tfid._compute_fid(*map(_t, args))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), _np_fid(real, fake), rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(jfid._compute_fid(*map(jnp.asarray, args))), **F64)

    def test_compute_fid_inside_a_compiled_program(self):
        """Where no value can be read (``trace_scope``), the finiteness
        branch is a ``torch.where`` and the value stays the eager one."""
        real = _rng.randn(32, 8)
        fake = _rng.randn(32, 8) + 0.5
        args = tuple(map(_t, (real.mean(0), np.cov(real, rowvar=False), fake.mean(0), np.cov(fake, rowvar=False))))
        with trace_scope():
            traced = tfid._compute_fid(*args)
        np.testing.assert_allclose(traced.numpy(), _np_fid(real, fake), rtol=1e-6)

    def test_fid_newton_schulz_method_matches_eigh(self):
        real_imgs = _rng.rand(48, 3, 6, 6).astype(np.float32)
        fake_imgs = (_rng.rand(48, 3, 6, 6) * 0.7).astype(np.float32)
        values = []
        for method in ("eigh", "ns"):
            jm, tm = _feed(_pair("FID", feature=_flat_features, sqrtm_method=method),
                           [((real_imgs,), {"real": True}), ((fake_imgs,), {"real": False})])
            got = tm.compute()
            np.testing.assert_allclose(got.numpy(), np.asarray(jm.compute()), **F64)
            values.append(float(got))
        np.testing.assert_allclose(values[0], values[1], rtol=1e-4)

    def test_fid_invalid_sqrtm_method(self):
        with pytest.raises(ValueError, match="sqrtm_method"):
            T.FID(feature=_flat_features, sqrtm_method="cholesky", **CPU)

    @pytest.mark.parametrize("d, n, method", [(64, 200, "eigh"), (512, 600, "ns")])
    def test_fid_auto_picks_and_matches_jax(self, d, n, method):
        rng = np.random.RandomState(d)
        feats = lambda x: x  # noqa: E731
        real = rng.randn(n, d).astype(np.float32)
        fake = (rng.randn(n, d) * 0.9 + 0.1).astype(np.float32)
        jm, tm = _feed(_pair("FID", feature=feats), [((real,), {"real": True}), ((fake,), {"real": False})])
        assert tfid.resolve_sqrtm_method(n, d) == jfid.resolve_sqrtm_method(n, d) == method
        got = tm.compute()
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jm.compute()), rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), _np_fid(real.astype(np.float64), fake.astype(np.float64)),
                                   rtol=1e-5)

    def test_fid_auto_rank_deficient_stays_finite(self):
        rng = np.random.RandomState(6)
        d, n = 600, 100
        feats = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :d]  # noqa: E731
        fid = _quiet(lambda: T.FID(feature=feats, **CPU))
        fid.update(_t(rng.rand(n, 3, 20, 10).astype(np.float32)), real=True)
        fid.update(_t(rng.rand(n, 3, 20, 10).astype(np.float32)), real=False)
        value = float(fid.compute())
        assert np.isfinite(value) and value >= 0.0

    def test_fid_ns_nonfinite_rescues_to_eigh_eagerly(self):
        rng = np.random.RandomState(3)
        n, d = 33, 512
        m1, s1 = tfid._mean_cov(_t(rng.randn(n, d).astype(np.float32)))
        m2, s2 = tfid._mean_cov(_t(rng.randn(n, d).astype(np.float32)))
        assert not np.isfinite(float(tfid._trace_sqrt_product(s1, s2, "ns")))
        with pytest.warns(UserWarning, match="non-finite on the 'ns'"):
            rescued = float(tfid._compute_fid(m1, s1, m2, s2, method="ns"))
        via_eigh = float(tfid._compute_fid(m1, s1, m2, s2, method="eigh"))
        assert np.isfinite(rescued)
        np.testing.assert_allclose(rescued, via_eigh, rtol=1e-3)

    def test_fid_auto_dead_feature_dims_stays_finite(self):
        rng = np.random.RandomState(7)
        d, n = 512, 700

        def feats(imgs):
            flat = imgs.reshape(imgs.shape[0], -1)[:, :d].clone()
            flat[:, :32] = 1.25  # 32 dead dims -> singular covariance
            return flat

        fid, fid_eigh = _quiet(lambda: (T.FID(feature=feats, **CPU), T.FID(feature=feats, sqrtm_method="eigh", **CPU)))
        real = _t(rng.rand(n, 3, 20, 10).astype(np.float32))
        fake = _t(rng.rand(n, 3, 20, 10).astype(np.float32))
        for m in (fid, fid_eigh):
            m.update(real, real=True)
            m.update(fake, real=False)
        value = float(_quiet(fid.compute))
        assert np.isfinite(value) and value >= 0.0
        np.testing.assert_allclose(value, float(fid_eigh.compute()), rtol=1e-3)

    def test_fid_auto_exactly_dead_features_match_a_float64_oracle_on_the_live_ones(self):
        """Features that are zero for every image (a dead ReLU channel) leave
        zero rows and columns in both covariances; the Newton-Schulz form
        that ``'auto'`` picks keeps them exactly zero and needs no rescue, and
        the value equals scipy's on the live features."""
        rng = np.random.RandomState(8)
        d, n, dead = 512, 700, 40
        mix = rng.randn(d, d) * 0.05
        real = np.abs(rng.randn(n, d) @ mix + rng.randn(n, d))
        fake = np.abs(rng.randn(n, d) @ mix * 1.1 + rng.randn(n, d))
        real[:, :dead] = fake[:, :dead] = 0.0
        m1, s1 = tfid._mean_cov(_t(real))
        m2, s2 = tfid._mean_cov(_t(fake))
        assert tfid.resolve_sqrtm_method(n, d) == "ns"
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no rescue warning
            got = float(tfid._compute_fid(m1, s1, m2, s2, method="ns"))
        np.testing.assert_allclose(got, _np_fid(real[:, dead:], fake[:, dead:]), rtol=1e-9)

    def test_fid_metric_accumulates_batches(self):
        real_imgs = _rng.rand(40, 3, 6, 6).astype(np.float32)
        fake_imgs = (_rng.rand(40, 3, 6, 6) * 0.7).astype(np.float32)
        batches = []
        for chunk in range(4):
            batches.append(((real_imgs[chunk * 10:(chunk + 1) * 10],), {"real": True}))
            batches.append(((fake_imgs[chunk * 10:(chunk + 1) * 10],), {"real": False}))
        jm, tm = _feed(_pair("FID", feature=_flat_features), batches)
        expected = _np_fid(_flat_features(real_imgs).astype(np.float64), _flat_features(fake_imgs).astype(np.float64))
        got = tm.compute()
        np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(jm.compute()), rtol=1e-6)

    def test_fid_identical_distributions_is_zero(self):
        fid = _quiet(lambda: T.FID(feature=_flat_features, **CPU))
        imgs = _t(_rng.rand(32, 3, 6, 6).astype(np.float32))
        fid.update(imgs, real=True)
        fid.update(imgs, real=False)
        assert abs(float(fid.compute())) < 1e-6

    def test_fid_reset(self):
        fid = _quiet(lambda: T.FID(feature=_flat_features, **CPU))
        fid.update(torch.ones((4, 3, 6, 6)), real=True)
        fid.reset()
        assert fid.real_features == [] and fid.fake_features == []


class TestFIDStreaming:
    def test_streaming_matches_buffered_and_jax(self):
        rng = np.random.RandomState(21)
        batches = []
        for _ in range(4):
            batches.append(((rng.rand(24, 3, 6, 6).astype(np.float32),), {"real": True}))
            batches.append((((rng.rand(24, 3, 6, 6) * 0.8).astype(np.float32),), {"real": False}))
        jm, tm = _feed(_pair("FID", feature=_flat_features, streaming=True, feature_dim=16), batches)
        _, buffered = _feed(_pair("FID", feature=_flat_features), batches)
        got = tm.compute()
        assert got.dtype == torch.float64 and tm.real_outer.dtype == torch.float64 and tm.real_n.dtype == torch.int32
        np.testing.assert_allclose(got.numpy(), np.asarray(jm.compute()), **F64)
        np.testing.assert_allclose(float(got), float(buffered.compute()), rtol=1e-3, atol=1e-4)

    def test_streaming_requires_feature_dim_for_callables(self):
        with pytest.raises(ValueError, match="feature_dim"):
            T.FID(feature=_flat_features, streaming=True, **CPU)

    def test_streaming_infers_dim_from_tap(self):
        for tap, want in ((64, 64), (2048, 2048), ("logits_unbiased", 1008)):
            assert tfid._feature_dim_of(tap, None) == jfid._feature_dim_of(tap, None) == want
        assert tfid._feature_dim_of(_flat_features, 16) == 16

    def test_streaming_update_keeps_fixed_shapes_and_reads_nothing(self):
        rng = np.random.RandomState(22)
        metric = T.FID(feature=_flat_features, streaming=True, feature_dim=16, **CPU)
        state = metric.init_state()
        shapes = {k: tuple(v.shape) for k, v in state.items()}
        with trace_scope():  # as inside a compiled program: no value may be read
            for _ in range(3):
                imgs = _t(rng.rand(8, 3, 6, 6).astype(np.float32))
                state = metric.apply_update(state, imgs, real=True)
                state = metric.apply_update(state, imgs * 0.9, real=False)
        assert {k: tuple(v.shape) for k, v in state.items()} == shapes
        assert np.isfinite(float(metric.apply_compute(state, process_group=None)))

    def test_streaming_sync_over_two_ranks_matches_sequential(self):
        rng = np.random.RandomState(23)
        real = rng.rand(16, 3, 6, 6).astype(np.float32)
        fake = (rng.rand(16, 3, 6, 6) * 0.8).astype(np.float32)

        def rank(r):
            def run():
                m = T.FID(feature=_flat_features, streaming=True, feature_dim=16, **CPU)
                m.update(_t(real[r::2]), real=True)
                m.update(_t(fake[r::2]), real=False)
                with m.sync_context(distributed_available=lambda: True):
                    return m.compute()

            return run

        results, errors, _ = _run_ranks([rank(0), rank(1)], "torch")
        assert errors == [None, None]
        seq = T.FID(feature=_flat_features, streaming=True, feature_dim=16, **CPU)
        seq.update(_t(real), real=True)
        seq.update(_t(fake), real=False)
        for got in results:
            np.testing.assert_allclose(float(got), float(seq.compute()), rtol=1e-9, atol=1e-12)

    def test_streaming_no_footprint_warning(self, recwarn):
        T.FID(feature=_flat_features, streaming=True, feature_dim=16, **CPU)
        assert not any("footprint" in str(w.message) for w in recwarn.list)

    def test_streaming_single_sample_mean_is_exact(self):
        feats = torch.tensor([[2.0, 4.0, 6.0]], dtype=torch.float64)
        mean, cov = tfid._streaming_mean_cov(torch.tensor(1), feats.sum(0), feats.T @ feats)
        np.testing.assert_allclose(mean.numpy(), [2.0, 4.0, 6.0])
        np.testing.assert_allclose(cov.numpy(), 0.0, atol=1e-12)

    def test_streaming_empty_side_raises(self):
        fid = T.FID(feature=_flat_features, streaming=True, feature_dim=16, **CPU)
        fid.update(torch.ones((4, 3, 6, 6)), real=True)
        with pytest.raises(ValueError, match="at least one update per side"):
            fid.compute()


# -- KID ---------------------------------------------------------------------------------------


class TestKIDCapacity:
    def test_capacity_matches_buffered(self):
        rng = np.random.RandomState(24)
        capped = T.KID(feature=_flat_features, subsets=3, subset_size=8, capacity=64, feature_dim=16, **CPU)
        buffered = _quiet(lambda: T.KID(feature=_flat_features, subsets=3, subset_size=8, **CPU))
        for _ in range(3):
            real = _t(rng.rand(12, 3, 6, 6).astype(np.float32))
            fake = _t((rng.rand(12, 3, 6, 6) * 0.8).astype(np.float32))
            for m in (capped, buffered):
                m.update(real, real=True)
                m.update(fake, real=False)
        got, want = capped.compute(), buffered.compute()
        # identical features in identical order and the same seed: equal
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)

    def test_capacity_overflow_drops_and_warns(self):
        rng = np.random.RandomState(25)
        capped = T.KID(feature=_flat_features, subsets=2, subset_size=4, capacity=16, feature_dim=16, **CPU)
        first16 = _quiet(lambda: T.KID(feature=_flat_features, subsets=2, subset_size=4, **CPU))
        real = _t(rng.rand(24, 3, 6, 6).astype(np.float32))
        fake = _t((rng.rand(24, 3, 6, 6) * 0.8).astype(np.float32))
        capped.update(real, real=True)
        capped.update(fake, real=False)
        first16.update(real[:16], real=True)
        first16.update(fake[:16], real=False)
        with pytest.warns(UserWarning, match="dropped"):
            got = capped.compute()
        np.testing.assert_allclose(float(got[0]), float(first16.compute()[0]), rtol=1e-6)

    def test_capacity_update_keeps_fixed_shapes(self):
        rng = np.random.RandomState(26)
        metric = T.KID(feature=_flat_features, subsets=2, subset_size=4, capacity=64, feature_dim=16, **CPU)
        state = metric.init_state()
        shapes = {k: tuple(v.shape) for k, v in state.items()}
        with trace_scope():
            for _ in range(4):
                state = metric.apply_update(state, _t(rng.rand(8, 3, 6, 6).astype(np.float32)), real=True)
        assert {k: tuple(v.shape) for k, v in state.items()} == shapes and int(state["real_count"]) == 32

    def test_capacity_traced_compute_raises(self):
        metric = T.KID(feature=_flat_features, subsets=2, subset_size=4, capacity=16, feature_dim=16, **CPU)
        state = metric.apply_update(metric.init_state(), torch.ones((8, 3, 6, 6)), real=True)
        state = metric.apply_update(state, torch.ones((8, 3, 6, 6)) * 0.5, real=False)
        with trace_scope(), pytest.raises(NotImplementedError, match="capacity"):
            metric.apply_compute(state, process_group=None)


class TestKID:
    def test_kid_full_subset_matches_direct_mmd_and_jax(self):
        # subset_size == n makes the draws irrelevant: both packages agree
        real = _rng.randn(24, 8).astype(np.float64)
        fake = (_rng.randn(24, 8) + 0.3).astype(np.float64)
        jm, tm = _feed(_pair("KID", feature=lambda x: x, subsets=3, subset_size=24),
                       [((real,), {"real": True}), ((fake,), {"real": False})])
        mean, std = tm.compute()
        jmean, jstd = jm.compute()
        np.testing.assert_allclose(mean.numpy(), np.asarray(jkid.poly_mmd(jnp.asarray(real), jnp.asarray(fake))),
                                   rtol=1e-12)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-12)
        np.testing.assert_allclose(std.numpy(), 0.0, atol=1e-8)
        np.testing.assert_allclose(float(jstd), 0.0, atol=1e-8)

    def test_kid_on_float32_features_matches_jax(self):
        rng = np.random.RandomState(30)
        real = rng.randn(40, 32).astype(np.float32)
        fake = (rng.randn(40, 32) * 1.1 + 0.2).astype(np.float32)
        jm, tm = _feed(_pair("KID", feature=lambda x: x, subsets=5, subset_size=40),
                       [((real,), {"real": True}), ((fake,), {"real": False})])
        mean, _ = tm.compute()
        assert mean.dtype == torch.float32
        np.testing.assert_allclose(mean.numpy(), np.asarray(jm.compute()[0]), rtol=1e-5)

    def test_kid_subsets_are_batched_poly_mmds_of_the_drawn_indices(self):
        """The batched form equals a loop of ``poly_mmd`` over the subset
        indices the metric's seed draws, and repeated computes agree."""
        rng = np.random.RandomState(31)
        real, fake = _t(rng.randn(30, 6)), _t(rng.randn(30, 6) + 0.5)
        kid = _quiet(lambda: T.KID(feature=lambda x: x, subsets=7, subset_size=10, rng_seed=5, **CPU))
        kid.update(real, real=True)
        kid.update(fake, real=False)
        gen = torch.Generator().manual_seed(5)
        ridx = tkid.subset_indices(gen, 7, 30, 10)
        fidx = tkid.subset_indices(gen, 7, 30, 10)
        loop = torch.stack([tkid.poly_mmd(real[r], fake[f]) for r, f in zip(ridx, fidx)])
        mean, std = kid.compute()
        np.testing.assert_allclose(mean.numpy(), loop.mean().numpy(), rtol=1e-12)
        np.testing.assert_allclose(std.numpy(), loop.std(correction=0).numpy(), rtol=1e-12)
        kid.reset()
        kid.update(real, real=True)
        kid.update(fake, real=False)
        assert torch.equal(kid.compute()[0], mean)

    def test_kid_orders_distribution_distance(self):
        feats = _t(_rng.randn(50, 8))
        kid_same, kid_diff = _quiet(lambda: [T.KID(feature=lambda x: x, subsets=10, subset_size=20, **CPU)
                                             for _ in range(2)])
        kid_same.update(feats, real=True)
        kid_same.update(feats, real=False)
        kid_diff.update(feats, real=True)
        kid_diff.update(feats + 2.0, real=False)
        assert abs(float(kid_same.compute()[0])) < 0.1 * float(kid_diff.compute()[0])

    def test_kid_subset_size_too_large_raises(self):
        kid = _quiet(lambda: T.KID(feature=lambda x: x, subsets=2, subset_size=100, **CPU))
        kid.update(_t(_rng.randn(10, 4)), real=True)
        kid.update(_t(_rng.randn(10, 4)), real=False)
        with pytest.raises(ValueError, match="subset_size"):
            kid.compute()

    @pytest.mark.parametrize(
        "kwargs", [dict(subsets=0), dict(subset_size=-1), dict(degree=0), dict(gamma=-1.0), dict(coef=0.0)]
    )
    def test_kid_invalid_args(self, kwargs):
        with pytest.raises(ValueError):
            _quiet(lambda: T.KID(feature=lambda x: x, **kwargs, **CPU))


# -- IS ------------------------------------------------------------------------------------------


def _np_inception_score(logits, splits):
    logits = logits - scipy.special.logsumexp(logits, axis=-1, keepdims=True)
    prob = np.exp(logits)
    n = logits.shape[0] // splits
    scores = []
    for i in range(splits):
        p = prob[i * n:(i + 1) * n]
        lp = logits[i * n:(i + 1) * n]
        marginal = p.mean(0, keepdims=True)
        scores.append(np.exp((p * (lp - np.log(marginal))).sum(-1).mean()))
    return np.mean(scores), np.std(scores, ddof=1) if splits > 1 else 0.0


class TestISCapacity:
    def test_capacity_matches_buffered(self):
        rng = np.random.RandomState(27)
        logits = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :10]  # noqa: E731
        capped = T.IS(feature=logits, splits=2, capacity=64, feature_dim=10, **CPU)
        buffered = _quiet(lambda: T.IS(feature=logits, splits=2, **CPU))
        for _ in range(3):
            imgs = _t(rng.rand(12, 3, 4, 4).astype(np.float32))
            capped.update(imgs)
            buffered.update(imgs)
        got, want = capped.compute(), buffered.compute()
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)

    def test_capacity_overflow_drops_and_warns(self):
        rng = np.random.RandomState(28)
        logits = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :10]  # noqa: E731
        capped = T.IS(feature=logits, splits=2, capacity=8, feature_dim=10, **CPU)
        imgs = _t(rng.rand(20, 3, 4, 4).astype(np.float32))
        capped.update(imgs)
        with pytest.warns(UserWarning, match="dropped"):
            mean, _ = capped.compute()
        first8 = _quiet(lambda: T.IS(feature=logits, splits=2, **CPU))
        first8.update(imgs[:8])
        np.testing.assert_allclose(float(mean), float(first8.compute()[0]), rtol=1e-6)


class TestIS:
    def test_is_single_split_vs_numpy_and_jax(self):
        logits = _rng.randn(40, 10)
        jm, tm = _feed(_pair("IS", feature=lambda x: x, splits=1), [((logits,), {})])
        mean, std = tm.compute()
        np.testing.assert_allclose(mean.numpy(), _np_inception_score(logits, 1)[0], rtol=1e-6)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jm.compute()[0]), rtol=1e-12)
        assert float(std) == 0.0

    def test_is_multi_split_equals_numpy_on_the_drawn_permutation(self):
        logits = _rng.randn(43, 10)
        metric = _quiet(lambda: T.IS(feature=lambda x: x, splits=4, rng_seed=7, **CPU))
        metric.update(_t(logits))
        perm = torch.randperm(43, generator=torch.Generator().manual_seed(7)).numpy()
        want_mean, want_std = _np_inception_score(logits[perm][:40], 4)
        mean, std = metric.compute()
        np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-10)
        np.testing.assert_allclose(std.numpy(), want_std, rtol=1e-10)

    def test_is_uniform_logits_score_one(self):
        metric = _quiet(lambda: T.IS(feature=lambda x: x, splits=2, **CPU))
        metric.update(torch.zeros((20, 10)))
        mean, std = metric.compute()
        np.testing.assert_allclose(mean.numpy(), 1.0, atol=1e-6)
        np.testing.assert_allclose(std.numpy(), 0.0, atol=1e-6)

    def test_is_multi_split_finite(self):
        metric = _quiet(lambda: T.IS(feature=lambda x: x, splits=4, **CPU))
        metric.update(_t(_rng.randn(64, 10)))
        mean, std = metric.compute()
        assert float(mean) >= 1.0 and np.isfinite(float(std))

    def test_is_too_few_samples_raises(self):
        metric = _quiet(lambda: T.IS(feature=lambda x: x, splits=10, **CPU))
        metric.update(_t(_rng.randn(4, 10)))
        with pytest.raises(ValueError, match="splits"):
            metric.compute()


# -- InceptionV3 ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """The JAX package's random-weights Flax extractor and the port's net
    with those variables carried across."""
    extractor = jnet.InceptionFeatureExtractor(feature=2048, allow_random_weights=True, rng_seed=0)
    variables = jax.tree.map(np.asarray, extractor.variables)
    net = tnet.InceptionV3()
    net.load_state_dict(tnet.flax_variables_to_state_dict(variables), strict=True)
    return extractor, variables, net.eval()


def _flax_taps(extractor, imgs):
    x = jnp.asarray(imgs)
    x = (x.astype(jnp.float32) - 128.0) / 128.0 if imgs.dtype == np.uint8 else x * 2.0 - 1.0
    x = jnet._bilinear_resize(jnp.transpose(x, (0, 2, 3, 1)), 299)
    return {k: np.asarray(v) for k, v in extractor.net.apply(extractor.variables, x).items()}


class TestInceptionNet:
    @pytest.mark.parametrize("side", [299, 32, 320])
    def test_every_tap_matches_the_flax_net_carried_across(self, carried, side):
        extractor, _, net = carried
        imgs = np.random.RandomState(side).randint(0, 256, (2, 3, side, side)).astype(np.uint8)
        want = _flax_taps(extractor, imgs)
        for tap in TAPS:
            feature = tap if tap == "logits_unbiased" else int(tap)
            got = tnet.InceptionFeatureExtractor(feature, net=net, **CPU)(_t(imgs))
            assert got.dtype == torch.float32 and got.shape == want[tap].shape
            scale = np.abs(want[tap]).max()
            np.testing.assert_allclose(got.numpy() / scale, want[tap] / scale, rtol=0, atol=1e-4, err_msg=tap)

    def test_downsampling_needs_the_antialiased_resize(self, carried):
        """Without antialiasing, a 320 -> 299 resize would not be JAX's: it
        sits 0.16 off, where the antialiased one sits 3e-5 off on values in
        [0, 1] (the two packages round their float32 filter weights apart)."""
        imgs = np.random.RandomState(1).rand(1, 3, 320, 320).astype(np.float32)
        want = np.asarray(jnet._bilinear_resize(jnp.transpose(jnp.asarray(imgs), (0, 2, 3, 1)), 299))
        got = tnet._bilinear_resize(_t(imgs), 299).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)
        plain = torch.nn.functional.interpolate(_t(imgs), size=(299, 299), mode="bilinear", align_corners=False)
        assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2

    def test_feature_tap_shapes(self, carried):
        taps = carried[2](torch.zeros((2, 3, 299, 299)))
        assert {k: tuple(v.shape) for k, v in taps.items()} == {
            "64": (2, 64), "192": (2, 192), "768": (2, 768), "2048": (2, 2048), "logits_unbiased": (2, 1008)}

    def test_extractor_resizes_and_flattens(self):
        extractor = tnet.InceptionFeatureExtractor(feature=64, allow_random_weights=True, **CPU)
        assert extractor(torch.zeros((2, 3, 32, 32), dtype=torch.uint8)).shape == (2, 64)

    def test_extractor_uint8_and_unit_float_agree(self, carried):
        extractor = tnet.InceptionFeatureExtractor(feature=64, net=carried[2], **CPU)
        imgs_u8 = _rng.randint(0, 256, (2, 3, 32, 32)).astype(np.uint8)
        out_u8 = extractor(_t(imgs_u8))
        out_f = extractor(_t(imgs_u8.astype(np.float32) / 256.0))
        np.testing.assert_allclose(out_u8.numpy(), out_f.numpy(), atol=1e-4)

    def test_checkpoints_round_trip(self, carried, tmp_path):
        """A torchvision-named ``state_dict`` file and the JAX package's flat
        ``.npz`` export both load through ``weights_path`` into the same net."""
        extractor, variables, net = carried
        state = {k: v.clone() for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}
        state["fc.bias"] = torch.zeros(1008)  # torchvision's extra keys are ignored
        state["AuxLogits.fc.weight"] = torch.zeros(3, 4)
        torch.save(state, str(tmp_path / "inception.pth"))
        flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(variables)[0]}
        np.savez(str(tmp_path / "weights.npz"), **flat)
        imgs = _t(_rng.randint(0, 256, (1, 3, 299, 299)).astype(np.uint8))
        direct = tnet.InceptionFeatureExtractor("logits_unbiased", net=net, **CPU)(imgs)
        for name in ("inception.pth", "weights.npz"):
            loaded = tnet.InceptionFeatureExtractor("logits_unbiased", weights_path=str(tmp_path / name), **CPU)
            assert torch.equal(loaded(imgs), direct), name
        del state["Mixed_7c.branch_pool.bn.running_var"]
        torch.save(state, str(tmp_path / "short.pth"))
        with pytest.raises(KeyError, match="missing 1"):
            tnet.InceptionFeatureExtractor(weights_path=str(tmp_path / "short.pth"), **CPU)

    def test_weights_env_var_is_read(self, carried, tmp_path, monkeypatch):
        torch.save(carried[2].state_dict(), str(tmp_path / "w.pth"))
        monkeypatch.setenv("METRICS_TPU_INCEPTION_WEIGHTS", str(tmp_path / "w.pth"))
        assert tnet.inception_weights_available()
        fid = _quiet(lambda: T.FID(feature=64, **CPU))
        assert fid.inception.feature == 64

    def test_torchvision_name_map_is_the_jax_packages_and_covers_the_net(self, carried):
        assert tnet._torchvision_name_map() == jnet._torchvision_name_map()
        _, variables, net = carried
        flat = {"/".join(str(getattr(p, "key", p)) for p in path)
                for path, _ in jax.tree_util.tree_flatten_with_path(variables)[0]}
        assert set(tnet._torchvision_name_map()) == flat
        keys = {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
        assert set(tnet._torchvision_name_map().values()) == keys

    def test_carried_variables_invert_the_jax_converter(self, carried):
        _, variables, net = carried
        flat = jnet.torch_state_dict_to_flat(net.state_dict())
        for key, value in flat.items():
            node = variables
            for part in key.split("/"):
                node = node[part]
            np.testing.assert_array_equal(np.asarray(value), np.asarray(node), err_msg=key)


def test_seeded_weights_come_from_a_seeded_generator():
    a, b, c = tnet.seeded_inception(3), tnet.seeded_inception(3), tnet.seeded_inception(4)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.Conv2d_1a_3x3.conv.weight, c.Conv2d_1a_3x3.conv.weight)
    taps = a(torch.zeros((1, 3, 299, 299)) + 0.5)
    assert all(bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0 for v in taps.values())


def test_default_feature_requires_weights(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_INCEPTION_WEIGHTS", raising=False)
    with pytest.raises(ValueError, match="pretrained weights"):
        _quiet(lambda: T.FID(**CPU))


def test_invalid_feature_tap():
    with pytest.raises(ValueError, match="feature"):
        tnet.InceptionFeatureExtractor(feature=100, allow_random_weights=True, **CPU)


def test_unknown_feature_type():
    with pytest.raises(TypeError):
        tnet.resolve_feature_extractor(3.14, **CPU)


def test_generative_names_are_exported_and_default_to_the_card():
    for name in ("FID", "KID", "IS"):
        assert hasattr(J, name) and hasattr(T, name)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _quiet(lambda: getattr(T, name)(feature=lambda x: x))


# -- the committed goldens -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    data = dict(np.load(GOLDEN_PATH))
    assert int(data["version"]) == GOLDEN_VERSION
    if not str(data["source"]).startswith("numpy-seeded"):
        pytest.skip("goldens were cut from a real checkpoint")
    return data


@pytest.fixture(scope="module")
def golden_state():
    return numpy_seeded_state_dict()


def test_port_net_reproduces_the_committed_goldens(golden, golden_state):
    """The port's net on the seeded checkpoint against the frozen features:
    float16 storage is the only permitted difference, as for the torch
    oracle (``tests/image/test_inception_goldens.py``)."""
    net = tnet.InceptionV3(num_logits=golden_state["fc.weight"].shape[0])
    net.load_state_dict({k: v for k, v in golden_state.items() if k != "fc.bias"}, strict=False)
    extractor_net = net.eval()
    imgs = golden_images()
    for tap in TAPS:
        feature = tap if tap == "logits_unbiased" else int(tap)
        got = tnet.InceptionFeatureExtractor(feature, net=extractor_net, **CPU)(_t(imgs)).numpy()
        ref = golden[f"tap_{tap}"].astype(np.float32)
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-3, err_msg=tap)


def test_port_net_equals_the_torch_oracle_on_the_golden_checkpoint(golden_state):
    net = tnet.InceptionV3(num_logits=golden_state["fc.weight"].shape[0])
    tnet._load(net, golden_state)
    imgs = golden_images()
    with torch.no_grad():
        got = net.eval()((torch.from_numpy(imgs.astype(np.float32)) - 128.0) / 128.0)
    want = torch_taps(golden_state, imgs)
    for tap in TAPS:
        np.testing.assert_allclose(got[tap].numpy(), want[tap], rtol=1e-5, atol=1e-6, err_msg=tap)


def test_port_extractor_reads_threads_safely_shared_nets(carried):
    """Two threads share one net through two extractors (as FID and KID
    may): each gets the features of its own images."""
    net = carried[2]
    imgs = [_t(np.random.RandomState(s).randint(0, 256, (1, 3, 40, 40)).astype(np.uint8)) for s in (1, 2)]
    want = [tnet.InceptionFeatureExtractor(2048, net=net, **CPU)(x) for x in imgs]
    out = [None, None]

    def run(i):
        out[i] = tnet.InceptionFeatureExtractor(2048, net=net, **CPU)(imgs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    for got, w in zip(out, want):
        assert torch.equal(got, w)
