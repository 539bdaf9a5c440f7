"""Dice score.

Counterpart of ``metrics_tpu/functional/classification/dice.py``: one
vectorized one-hot reduction over the classes, the no-foreground and NaN
policies as ``where`` selects.
"""
import torch

from metrics_tpu_torch.utilities.data import Tensor, to_categorical
from metrics_tpu_torch.utilities.distributed import reduce


def dice_score(
    preds: Tensor,
    target: Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Dice coefficient ``2·tp / (2·tp + fp + fn)`` per class.

    Args:
        preds: ``(N, C, ...)`` class probabilities.
        target: ``(N, ...)`` integer labels.
        bg: include the background class (index 0).
        nan_score: value used where the denominator is zero.
        no_fg_score: value used for classes absent from ``target``.
        reduction: ``'elementwise_mean' | 'sum' | 'none'``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import dice_score
        >>> pred = torch.tensor([[0.85, 0.05, 0.05, 0.05],
        ...                      [0.05, 0.85, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.85, 0.05],
        ...                      [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> dice_score(pred, target)
        tensor(0.3333)
    """
    num_classes = preds.shape[1]
    start = 0 if bg else 1

    labels = to_categorical(preds) if preds.ndim == target.ndim + 1 else preds
    labels = labels.reshape(-1)
    flat_target = target.reshape(-1)

    classes = torch.arange(start, num_classes, device=preds.device)
    p_onehot = labels[:, None] == classes[None, :]  # (n, C - start)
    t_onehot = flat_target[:, None] == classes[None, :]

    tp = torch.sum(p_onehot & t_onehot, dim=0).to(torch.float32)
    fp = torch.sum(p_onehot & ~t_onehot, dim=0).to(torch.float32)
    fn = torch.sum(~p_onehot & t_onehot, dim=0).to(torch.float32)

    denom = 2 * tp + fp + fn
    nan = torch.full_like(denom, nan_score)
    scores = torch.where(denom == 0, nan, 2 * tp / torch.where(denom == 0, torch.ones_like(denom), denom))
    scores = torch.where(torch.any(t_onehot, dim=0), scores, torch.full_like(scores, no_fg_score))
    return reduce(scores, reduction=reduction)
