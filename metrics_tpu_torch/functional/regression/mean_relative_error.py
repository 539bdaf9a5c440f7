"""Deprecated ``mean_relative_error`` alias.

Counterpart of ``metrics_tpu/functional/regression/mean_relative_error.py``:
the alias of :func:`mean_absolute_percentage_error`, with the JAX package's
deprecation warning.
"""
from warnings import warn

from metrics_tpu_torch.functional.regression.mean_absolute_percentage_error import (
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
)
from metrics_tpu_torch.utilities.data import Tensor


def mean_relative_error(preds: Tensor, target: Tensor) -> Tensor:
    """Deprecated alias of :func:`mean_absolute_percentage_error`."""
    warn(
        "Function `mean_relative_error` was deprecated v0.4 and will be removed in v0.5."
        "Use `mean_absolute_percentage_error` instead.",
        DeprecationWarning,
    )
    sum_rltv_error, n_obs = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(sum_rltv_error, n_obs)
