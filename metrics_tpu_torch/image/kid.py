"""Kernel Inception Distance.

Counterpart of ``metrics_tpu/image/kid.py``: every subset's index vector is
drawn at once, and the polynomial-kernel MMD runs batched over the subset
axis (``torch.bmm`` over ``(subsets, subset_size, d)`` gathers) in place of
a host loop of ``subsets`` launches. The kernel blocks' sums accumulate in
float64 (:func:`maximum_mean_discrepancy`).

The subsets come from a CPU ``torch.Generator`` seeded by ``rng_seed`` in
each ``compute()`` (a random permutation per subset, the argsort of uniform
draws, cut to ``subset_size``; ``kid.py:191-198`` draws them with
``jax.random.permutation``), copied to the metric's device: repeated
computes on one state agree, the card's value equals the CPU's, and values
equal the JAX package's only for the same subsets.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.image.inception_net import feature_dim_of, resolve_feature_extractor
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.capped_buffer import feature_buffer_read, feature_buffer_write, init_feature_buffer
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat, full_fp32
from metrics_tpu_torch.utilities.prints import rank_zero_warn


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """Polynomial kernel matrix ``(γ·f1 f2ᵀ + coef)^degree`` of the last two
    axes (leading axes batch)."""
    if gamma is None:
        gamma = 1.0 / f1.shape[-1]
    with full_fp32(f1.device):
        return (f1 @ f2.transpose(-1, -2) * gamma + coef) ** degree


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    """Unbiased MMD² estimate from the three kernel blocks (leading axes batch).

    The block sums accumulate in float64 and the estimate is cast back to
    the blocks' dtype: MMD² is a small difference of three means near 1, so
    a float32 sum of a 1000 x 1000 block (its rounding about 1e-7 of the
    mean) would move a KID of 1e-3 by about 1e-4 of itself."""
    m = k_xx.shape[-1]

    def total(k: Tensor) -> Tensor:
        return k.sum(dim=(-2, -1), dtype=torch.float64)

    def trace(k: Tensor) -> Tensor:
        return torch.diagonal(k, dim1=-2, dim2=-1).sum(-1, dtype=torch.float64)

    kt_xx_sum = (total(k_xx) - trace(k_xx)) / (m * (m - 1))
    kt_yy_sum = (total(k_yy) - trace(k_yy)) / (m * (m - 1))
    k_xy_sum = total(k_xy) / (m**2)
    return (kt_xx_sum + kt_yy_sum - 2 * k_xy_sum).to(k_xx.dtype)


def poly_mmd(
    f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> Tensor:
    """Polynomial-kernel MMD² between two feature matrices (or batches of them)."""
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


def subset_indices(generator: torch.Generator, subsets: int, n: int, subset_size: int) -> Tensor:
    """``(subsets, subset_size)`` rows, each the first ``subset_size``
    entries of a uniform random permutation of ``range(n)``."""
    return torch.argsort(torch.rand(subsets, n, generator=generator), dim=1)[:, :subset_size]


class KID(Metric):
    """Kernel inception distance: mean/std of MMD² over random feature subsets.

    Args:
        feature: InceptionV3 tap (int/str, needs pretrained weights) or a
            callable ``(N, 3, H, W) -> (N, d)`` feature extractor.
        subsets: number of random subsets the score is averaged over.
        subset_size: samples drawn (without replacement) per subset.
        degree / gamma / coef: polynomial kernel parameters.
        rng_seed: seed of the subset draws.
        capacity: preallocate fixed ``(capacity, d)`` feature buffers per side
            instead of unbounded lists; rows past capacity are dropped with a
            warning at ``compute()``.
        feature_dim: feature dimensionality ``d`` (required with ``capacity=``
            when ``feature`` is a callable).
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image.kid import KID
        >>> feats = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :8]
        >>> kid = KID(feature=feats, subsets=3, subset_size=4, device="cpu")
        >>> imgs = torch.linspace(0, 1, 6 * 3 * 4 * 4).reshape(6, 3, 4, 4)
        >>> kid.update(imgs, real=True)
        >>> kid.update(imgs * 0.9, real=False)
        >>> kid_mean, kid_std = kid.compute()
        >>> bool(torch.isfinite(kid_mean))
        True
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(
        self,
        feature: Union[str, int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        rng_seed: int = 42,
        capacity: Optional[int] = None,
        feature_dim: Optional[int] = None,
        compute_on_step: bool = False,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        if capacity is None:
            rank_zero_warn(
                "Metric `KID` will save all extracted features in buffer."
                " For large datasets this may lead to large memory footprint."
                " Pass `capacity=` for a fixed-size buffer.",
                UserWarning,
            )
        self.inception = resolve_feature_extractor(feature, device=self.device)

        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        self.rng_seed = rng_seed

        self.capacity = capacity
        if capacity is not None:
            d = feature_dim_of(feature, feature_dim)
            self.feature_dim = d
            for side in ("real", "fake"):
                buf, self._buf_slack = init_feature_buffer(capacity, d, device=self.device)
                self.add_state(f"{side}_buf", buf, dist_reduce_fx="cat")
                self.add_state(f"{side}_count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="cat")
        else:
            self.add_state("real_features", [], dist_reduce_fx=None)
            self.add_state("fake_features", [], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract features for ``imgs`` and buffer them under the ``real`` flag."""
        features = self.inception(imgs)
        side = "real" if real else "fake"
        if self.capacity is not None:
            buf, count = feature_buffer_write(
                getattr(self, f"{side}_buf"), getattr(self, f"{side}_count"), features, self.capacity,
                self._buf_slack,
            )
            setattr(self, f"{side}_buf", buf)
            setattr(self, f"{side}_count", count)
        else:
            getattr(self, f"{side}_features").append(features)

    def _all_features(self) -> Tuple[Tensor, Tensor]:
        if self.capacity is not None:
            owner = type(self).__name__
            return (
                feature_buffer_read(self.real_buf, self.real_count, self.capacity, self._buf_slack, owner),
                feature_buffer_read(self.fake_buf, self.fake_count, self.capacity, self._buf_slack, owner),
            )
        return dim_zero_cat(self.real_features), dim_zero_cat(self.fake_features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(mean, std) of KID over ``subsets`` random subset pairs."""
        real_features, fake_features = self._all_features()

        n_real, n_fake = real_features.shape[0], fake_features.shape[0]
        if n_real < self.subset_size or n_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        generator = torch.Generator().manual_seed(self.rng_seed)
        real_idx = subset_indices(generator, self.subsets, n_real, self.subset_size).to(real_features.device)
        fake_idx = subset_indices(generator, self.subsets, n_fake, self.subset_size).to(fake_features.device)
        kid_scores = poly_mmd(real_features[real_idx], fake_features[fake_idx], self.degree, self.gamma, self.coef)
        return kid_scores.mean(), kid_scores.std(correction=0)
