"""Inception Score.

Counterpart of ``metrics_tpu/image/inception.py``: the permuted logits
reshape to ``(splits, n_per_split, classes)`` (trimmed to a multiple of
``splits``, ``inception.py:121-127``) and the whole score — softmax,
marginal, KL, exp — is one batched program. The shuffle is a permutation
from a CPU ``torch.Generator`` seeded by ``rng_seed`` in each ``compute()``
(``inception.py:119`` draws it with ``jax.random.permutation``), copied to
the metric's device, so the card's value equals the CPU's.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.image.inception_net import feature_dim_of, resolve_feature_extractor
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.capped_buffer import feature_buffer_read, feature_buffer_write, init_feature_buffer
from metrics_tpu_torch.utilities.data import Tensor, dim_zero_cat
from metrics_tpu_torch.utilities.prints import rank_zero_warn


class IS(Metric):
    """Inception score: ``exp(E_x KL(p(y|x) ‖ p(y)))`` over feature splits.

    Args:
        feature: InceptionV3 tap (defaults to ``'logits_unbiased'``; int/str
            taps need pretrained weights) or a callable ``(N, 3, H, W) ->
            (N, num_classes)`` returning classification logits.
        splits: number of splits for the mean/std estimate.
        rng_seed: seed of the pre-split shuffle.
        capacity: preallocate a fixed ``(capacity, C)`` logit buffer instead
            of an unbounded list; rows past capacity are dropped with a
            warning at ``compute()``.
        feature_dim: logit dimensionality ``C`` (required with ``capacity=``
            when ``feature`` is a callable).
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
        device: the common lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image.inception import IS
        >>> logits = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :10]
        >>> inception = IS(feature=logits, splits=2, device="cpu")
        >>> imgs = torch.linspace(0, 255, 8 * 3 * 4 * 4).reshape(8, 3, 4, 4)
        >>> inception.update(imgs)
        >>> score_mean, score_std = inception.compute()
        >>> bool(score_mean >= 1.0)
        True
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        feature: Union[str, int, Callable] = "logits_unbiased",
        splits: int = 10,
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
                "Metric `IS` will save all extracted features in buffer."
                " For large datasets this may lead to large memory footprint."
                " Pass `capacity=` for a fixed-size buffer.",
                UserWarning,
            )
        self.inception = resolve_feature_extractor(feature, device=self.device)
        self.splits = splits
        self.rng_seed = rng_seed

        self.capacity = capacity
        if capacity is not None:
            d = feature_dim_of(feature, feature_dim)
            self.feature_dim = d
            buf, self._buf_slack = init_feature_buffer(capacity, d, device=self.device)
            self.add_state("features_buf", buf, dist_reduce_fx="cat")
            self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="cat")
        else:
            self.add_state("features", [], dist_reduce_fx=None)

    def update(self, imgs: Tensor) -> None:
        """Extract classification logits for ``imgs`` and buffer them."""
        logits = self.inception(imgs)
        if self.capacity is not None:
            self.features_buf, self.count = feature_buffer_write(
                self.features_buf, self.count, logits, self.capacity, self._buf_slack
            )
        else:
            self.features.append(logits)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(mean, std) of the per-split inception scores."""
        if self.capacity is not None:
            features = feature_buffer_read(
                self.features_buf, self.count, self.capacity, self._buf_slack, type(self).__name__
            )
        else:
            features = dim_zero_cat(self.features)
        generator = torch.Generator().manual_seed(self.rng_seed)
        features = features[torch.randperm(features.shape[0], generator=generator).to(features.device)]

        n_per_split = features.shape[0] // self.splits
        if n_per_split == 0:
            raise ValueError(f"Not enough samples ({features.shape[0]}) for {self.splits} splits")
        features = features[: n_per_split * self.splits].reshape(self.splits, n_per_split, -1)

        log_prob = torch.log_softmax(features, dim=-1)
        prob = torch.exp(log_prob)
        marginal = prob.mean(dim=1, keepdim=True)  # p(y) per split
        kl = (prob * (log_prob - torch.log(marginal))).sum(dim=-1)  # (splits, n)
        scores = torch.exp(kl.mean(dim=-1))  # (splits,)
        std = scores.std(correction=1) if self.splits > 1 else torch.zeros_like(scores.mean())
        return scores.mean(), std
