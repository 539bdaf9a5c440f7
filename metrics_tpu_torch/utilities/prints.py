"""Rank-zero-gated logging/warning helpers.

Counterpart of ``metrics_tpu/utilities/prints.py``. The rank comes from the
``GLOBAL_RANK``/``RANK``/``LOCAL_RANK`` environment variables that launchers
set, else from ``torch.distributed`` when a process group is initialised,
else 0.
"""
import logging
import os
import warnings
from functools import partial, wraps
from typing import Any, Callable

import torch.distributed as dist

log = logging.getLogger("metrics_tpu_torch")


def _detect_rank() -> int:
    for env_key in ("GLOBAL_RANK", "RANK", "LOCAL_RANK"):
        if env_key in os.environ:
            return int(os.environ[env_key])
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Decorator: run ``fn`` only on global rank zero."""

    @wraps(fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        if getattr(rank_zero_only, "rank", _detect_rank()) == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped


def _warn(message: str, *args: Any, **kwargs: Any) -> None:
    warnings.warn(message, *args, **kwargs)


def _info(message: str, *args: Any, **kwargs: Any) -> None:
    log.info(message, *args, **kwargs)


def _debug(message: str, *args: Any, **kwargs: Any) -> None:
    log.debug(message, *args, **kwargs)


rank_zero_warn = rank_zero_only(partial(_warn, stacklevel=5))
rank_zero_info = rank_zero_only(_info)
rank_zero_debug = rank_zero_only(_debug)
