"""Hamming distance (Hamming loss).

Counterpart of ``metrics_tpu/functional/classification/hamming_distance.py``:
two scalar sum states, ``correct`` element matches and ``total`` element
count, over the canonical binary tensors of ``_input_format_classification``.
"""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities.data import Tensor


def _hamming_distance_update(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tuple[Tensor, int]:
    preds, target, _ = _input_format_classification(preds, target, threshold=threshold)
    correct = torch.sum(preds == target).to(torch.int32)
    return correct, preds.numel()


def _hamming_distance_compute(correct: Tensor, total: Union[int, Tensor]) -> Tensor:
    return 1 - correct.to(torch.float32) / total


def hamming_distance(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tensor:
    """Average fraction of per-label disagreements between preds and target.

    Equals ``1 - accuracy`` for binary data; every other input case is
    treated label-wise (as if multi-label).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import hamming_distance
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> hamming_distance(preds, target)
        tensor(0.2500)
    """
    correct, total = _hamming_distance_update(preds, target, threshold)
    return _hamming_distance_compute(correct, total)
