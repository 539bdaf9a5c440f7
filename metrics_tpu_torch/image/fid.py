"""Fréchet Inception Distance.

Counterpart of ``metrics_tpu/image/fid.py``. The whole formula stays on the
metric's device: ``Tr((Σ₁Σ₂)^{1/2})`` comes from the Newton–Schulz
iteration (matmul only, :func:`sqrtm_newton_schulz`) or from the symmetric
form ``Tr((Σ₁^{1/2} Σ₂ Σ₁^{1/2})^{1/2})`` with PSD square roots from
``torch.linalg.eigh``/``eigvalsh`` (library calls: the JAX package computes
them outside any Pallas kernel). ``sqrtm_method="auto"`` picks Newton–Schulz
at ``d >= 512`` with more samples than feature dims on both sides, eigh
otherwise (:func:`resolve_sqrtm_method`).

The port has no x64 switch: the moments and the compute are float64, as the
reference's are and as the JAX package's are under x64. So every product
that feeds a square root is a float64 product, which TF32 never touches:
the JAX package pins ``precision="float32"`` (``fid.py:68,83``) for the
float32 products it runs without x64.

States: the buffered feature lists, or with ``streaming=True`` the exact
linear moments per side (count, feature sum, outer-product sum,
``fid.py:264-280``): fixed shape, O(d²) memory.
"""
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.image.inception_net import feature_dim_of, resolve_feature_extractor
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import Tensor, _is_traced, dim_zero_cat
from metrics_tpu_torch.utilities.prints import rank_zero_warn


def sqrtm_psd(mat: Tensor) -> Tensor:
    """Square root of a positive semi-definite matrix by eigendecomposition;
    negative eigenvalues (numerical noise) are clamped to zero."""
    mat = (mat + mat.T) / 2.0
    eigvals, eigvecs = torch.linalg.eigh(mat)
    eigvals = torch.clamp(eigvals, min=0.0)
    return (eigvecs * torch.sqrt(eigvals)) @ eigvecs.T


def sqrtm_newton_schulz(mat: Tensor, num_iters: int = 32) -> Tensor:
    """Matrix square root by the coupled Newton–Schulz iteration
    (``fid.py:42-76``): ``num_iters`` steps of three matmuls each. Wants a
    full-rank input: the coupled iterate tracks ``A^{-1/2}``, which grows
    without bound in the null space of a singular matrix, where float32
    rounding drives it to NaN (``FID``'s ``'auto'`` mode routes
    rank-deficient covariances to eigh; an exactly zero feature stays zero
    here)."""
    dim = mat.shape[0]
    norm = torch.sqrt(torch.sum(mat * mat))
    y = mat / norm
    eye = torch.eye(dim, dtype=mat.dtype, device=mat.device)
    z = eye
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def _trace_sqrt_product(sigma1: Tensor, sigma2: Tensor, method: str = "eigh") -> Tensor:
    """``Tr((Σ₁ Σ₂)^{1/2})`` — PSD-symmetrized eigh form, or Newton–Schulz."""
    if method == "ns":
        return torch.trace(sqrtm_newton_schulz(sigma1 @ sigma2))
    s1_half = sqrtm_psd(sigma1)
    inner = (s1_half @ sigma2) @ s1_half
    inner = (inner + inner.T) / 2.0
    eigvals = torch.clamp(torch.linalg.eigvalsh(inner), min=0.0)
    return torch.sum(torch.sqrt(eigvals))


def _compute_fid(
    mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor, eps: float = 1e-6, method: str = "eigh"
) -> Tensor:
    """``‖μ₁-μ₂‖² + Tr(Σ₁ + Σ₂ - 2(Σ₁Σ₂)^{1/2})`` (``fid.py:97-138``).

    A non-finite trace term is retried with an ``eps`` jitter on the
    diagonals. Eagerly this is a branch on ONE host read of ``isfinite``
    (the only read of the compute): a non-finite Newton–Schulz trace
    retries with the eigh form, which clips the zero eigenvalues of a
    singular product exactly; an eigh trace retries with eigh. Where no
    value can be read (a compiled program), both branches run and
    ``torch.where`` picks, the same-method retry of ``lax.cond``.
    """
    diff = mu1 - mu2
    base = diff @ diff + torch.trace(sigma1) + torch.trace(sigma2)

    def _with_jitter(rescue_method: str) -> Tensor:
        offset = torch.eye(sigma1.shape[0], dtype=sigma1.dtype, device=sigma1.device) * eps
        return _trace_sqrt_product(sigma1 + offset, sigma2 + offset, rescue_method)

    tr_covmean = _trace_sqrt_product(sigma1, sigma2, method)
    finite = torch.isfinite(tr_covmean)
    if _is_traced(finite):
        tr_covmean = torch.where(finite, tr_covmean, _with_jitter(method))
    elif not bool(finite):  # the host read
        rescue = "eigh" if method == "ns" else method
        rank_zero_warn(
            f"FID trace term was non-finite on the '{method}' sqrtm path;"
            f" retrying with jittered '{rescue}' (the input covariance product"
            " is likely singular — e.g. dead feature dimensions).",
            UserWarning,
        )
        tr_covmean = _with_jitter(rescue)
    return base - 2.0 * tr_covmean


def _mean_cov(features: Tensor) -> Tuple[Tensor, Tensor]:
    """Sample mean and unbiased covariance of an ``(N, d)`` feature matrix."""
    n = features.shape[0]
    mean = features.mean(dim=0)
    diff = features - mean
    cov = (diff.T @ diff) / (n - 1)
    return mean, cov


def _feature_dim_of(feature: Union[int, str, Callable], feature_dim: Optional[int]) -> int:
    """Alias of :func:`metrics_tpu_torch.image.inception_net.feature_dim_of`."""
    return feature_dim_of(feature, feature_dim)


def resolve_sqrtm_method(n_min: Any, d: int, method: str = "auto") -> str:
    """The ``'auto'`` sqrtm dispatch (``fid.py:159-173``): Newton–Schulz at
    ``d >= 512`` with more samples than feature dims, eigh otherwise. Where
    the sample count is a tensor no value can be read from, size alone
    decides."""
    if method != "auto":
        return method
    if isinstance(n_min, Tensor) and _is_traced(n_min):
        return "ns" if d >= 512 else "eigh"
    return "ns" if (d >= 512 and int(n_min) > d) else "eigh"


def _streaming_mean_cov(n: Tensor, feat_sum: Tensor, outer_sum: Tensor) -> Tuple[Tensor, Tensor]:
    """Mean and unbiased covariance from the linear moments:
    ``Σ(x-μ)(x-μ)ᵀ = Σxxᵀ − n·μμᵀ``. The mean divides by the true count
    (clamped only against 0); only the Bessel denominator clamps at 1."""
    nf = torch.clamp(n, min=1).to(feat_sum.dtype)
    mean = feat_sum / nf
    cov = (outer_sum - nf * torch.outer(mean, mean)) / torch.clamp(nf - 1, min=1)
    return mean, cov


class FID(Metric):
    """Fréchet inception distance between the real and generated feature distributions.

    Args:
        feature: an int/str InceptionV3 tap (``64 | 192 | 768 | 2048 |
            'logits_unbiased'`` — needs pretrained weights, see
            :mod:`metrics_tpu_torch.image.inception_net`) or any callable
            mapping ``(N, 3, H, W)`` images to ``(N, d)`` features.
        sqrtm_method: ``'auto'`` (default), ``'eigh'`` or ``'ns'``.
        streaming: accumulate the exact float64 linear moments (count,
            feature sum, outer-product sum per side) instead of buffering
            every feature: fixed-shape states, O(d²) memory, a ``"sum"``
            sync.
        feature_dim: feature dimensionality ``d`` (required for
            ``streaming=True`` when ``feature`` is a callable).
        compute_on_step: defaults to ``False`` (a per-batch FID is not meaningful).
        dist_sync_on_step / process_group / dist_sync_fn / device: the common
            lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`; an
            int/str ``feature`` runs its net on ``device``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image.fid import FID
        >>> feats = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :8]
        >>> fid = FID(feature=feats, device="cpu")
        >>> imgs = torch.linspace(0, 1, 4 * 3 * 4 * 4).reshape(4, 3, 4, 4)
        >>> fid.update(imgs, real=True)
        >>> fid.update(imgs * 0.9, real=False)
        >>> bool(fid.compute() >= 0)
        True
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(
        self,
        feature: Union[int, str, Callable] = 2048,
        sqrtm_method: str = "auto",
        streaming: bool = False,
        feature_dim: Optional[int] = None,
        compute_on_step: bool = False,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable[[Tensor], List[Tensor]]] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.inception = resolve_feature_extractor(feature, device=self.device)
        if sqrtm_method not in ("auto", "eigh", "ns"):
            raise ValueError("Argument `sqrtm_method` expected to be 'auto', 'eigh' or 'ns'")
        self.sqrtm_method = sqrtm_method
        self.streaming = streaming

        if streaming:
            d = _feature_dim_of(feature, feature_dim)
            self.feature_dim = d
            for side in ("real", "fake"):
                self.add_state(f"{side}_n", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
                self.add_state(f"{side}_sum", torch.zeros((d,), dtype=torch.float64), dist_reduce_fx="sum")
                self.add_state(f"{side}_outer", torch.zeros((d, d), dtype=torch.float64), dist_reduce_fx="sum")
        else:
            rank_zero_warn(
                "Metric `FID` will save all extracted features in buffer."
                " For large datasets this may lead to large memory footprint."
                " Pass `streaming=True` for exact O(d**2) moment states.",
                UserWarning,
            )
            self.add_state("real_features", [], dist_reduce_fx=None)
            self.add_state("fake_features", [], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract features for ``imgs`` and buffer (or fold) them under the ``real`` flag."""
        features = self.inception(imgs)
        if self.streaming:
            side = "real" if real else "fake"
            feats = features.to(getattr(self, f"{side}_sum").dtype)
            setattr(self, f"{side}_n", getattr(self, f"{side}_n") + feats.shape[0])
            setattr(self, f"{side}_sum", getattr(self, f"{side}_sum") + feats.sum(dim=0))
            setattr(self, f"{side}_outer", getattr(self, f"{side}_outer") + feats.T @ feats)
        elif real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def _resolve_method(self, n_min: Any, d: int) -> str:
        return resolve_sqrtm_method(n_min, d, self.sqrtm_method)

    def compute(self) -> Tensor:
        """FID over all accumulated real/fake features."""
        if self.streaming:
            n_min = torch.minimum(self.real_n, self.fake_n)
            if not _is_traced(n_min) and int(n_min) == 0:
                raise ValueError(
                    "FID(streaming=True): at least one update per side (real and"
                    " fake) is required before compute()"
                )
            mean1, cov1 = _streaming_mean_cov(self.real_n, self.real_sum, self.real_outer)
            mean2, cov2 = _streaming_mean_cov(self.fake_n, self.fake_sum, self.fake_outer)
            return _compute_fid(mean1, cov1, mean2, cov2, method=self._resolve_method(n_min, cov1.shape[0]))

        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        orig_dtype = real_features.dtype
        mean1, cov1 = _mean_cov(real_features.to(torch.float64))
        mean2, cov2 = _mean_cov(fake_features.to(torch.float64))
        # Newton-Schulz needs full-rank covariances: rank-deficient inputs
        # (n <= d) take the eigh form, which clips zero eigenvalues exactly
        method = self._resolve_method(min(real_features.shape[0], fake_features.shape[0]), cov1.shape[0])
        return _compute_fid(mean1, cov1, mean2, cov2, method=method).to(orig_dtype)
