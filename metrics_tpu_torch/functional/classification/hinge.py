"""Hinge loss.

Counterpart of ``metrics_tpu/functional/classification/hinge.py``: the
binary margin, the multiclass Crammer-Singer margin (true-class score minus
the best other class) and one-vs-all (a per-class binary hinge), as
``where`` selects and a masked row max.
"""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utilities.data import Tensor, to_onehot
from metrics_tpu_torch.utilities.enums import DataType, EnumStr


class MulticlassMode(EnumStr):
    """Possible multiclass modes of hinge.

    >>> "Crammer-Singer" in list(MulticlassMode)
    True
    """

    CRAMMER_SINGER = "crammer-singer"
    ONE_VS_ALL = "one-vs-all"


def _check_shape_and_type_consistency_hinge(preds: Tensor, target: Tensor) -> DataType:
    if target.ndim > 1:
        raise ValueError(f"The `target` should be one dimensional, got `target` with shape={tuple(target.shape)}.")

    if preds.ndim == 1:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        return DataType.BINARY
    if preds.ndim == 2:
        if preds.shape[0] != target.shape[0]:
            raise ValueError(
                "The `preds` and `target` should have the same shape in the first dimension,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        return DataType.MULTICLASS
    raise ValueError(f"The `preds` should be one or two dimensional, got `preds` with shape={tuple(preds.shape)}.")


def _hinge_update(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tuple[Tensor, int]:
    if preds.shape[0] == 1:
        preds, target = preds.squeeze().unsqueeze(0), target.squeeze().unsqueeze(0)
    else:
        preds, target = preds.squeeze(), target.squeeze()

    mode = _check_shape_and_type_consistency_hinge(preds, target)

    if mode == DataType.MULTICLASS:
        target = to_onehot(target, max(2, preds.shape[1])).to(torch.bool)

    if mode == DataType.MULTICLASS and (multiclass_mode is None or multiclass_mode == MulticlassMode.CRAMMER_SINGER):
        # margin = score of the true class minus the best wrong-class score
        margin = torch.sum(torch.where(target, preds, torch.zeros_like(preds)), dim=1)
        margin = margin - torch.amax(torch.where(target, torch.full_like(preds, -torch.inf), preds), dim=1)
    elif mode == DataType.BINARY or multiclass_mode == MulticlassMode.ONE_VS_ALL:
        margin = torch.where(target.to(torch.bool), preds, -preds)
    else:
        raise ValueError(
            "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
            "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
            f" got {multiclass_mode}."
        )

    measures = torch.clamp(1 - margin, min=0)
    if squared:
        measures = measures**2
    # the row count stays a Python int: a tensor of it would be a copy to the card
    return torch.sum(measures, dim=0), target.shape[0]


def _hinge_compute(measure: Tensor, total: Union[int, Tensor]) -> Tensor:
    return measure / total


def hinge(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tensor:
    """Mean hinge loss ``max(0, 1 - margin)`` (optionally squared).

    Example (binary):
        >>> import torch
        >>> from metrics_tpu_torch.functional import hinge
        >>> target = torch.tensor([0, 1, 1])
        >>> preds = torch.tensor([-2.2, 2.4, 0.1])
        >>> print(f"{hinge(preds, target):.2f}")
        0.30
    """
    measure, total = _hinge_update(preds, target, squared=squared, multiclass_mode=multiclass_mode)
    return _hinge_compute(measure, total)
