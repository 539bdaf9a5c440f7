"""State byte counts, and the cost reports a CUDA graph cannot give.

Counterpart of ``metrics_tpu/observability/cost.py``. :func:`leaf_nbytes`
and :func:`pytree_nbytes` count a state's bytes as ``numel * element_size``
over tensors and lists of tensors: metadata only, nothing is read from the
card. They back ``state_memory_report`` and the memory ledger.

The JAX package's :func:`program_cost` and :func:`executable_cost` read
XLA's ``cost_analysis()``/``memory_analysis()`` of a compiled program. A
CUDA graph (the port's compiled program) and an eager PyTorch call carry no
such analysis, so both return the JAX report's keys as
``{"available": False, "reason": ...}``: no FLOP or byte figure is made up.
Every caller already reads ``available`` before it reads a figure.
"""
from typing import Any, Callable, Dict

import torch

#: why the port has no compiler cost figures
NO_COST_ANALYSIS = "no XLA cost analysis: a CUDA graph and an eager PyTorch call carry none"


def executable_cost(compiled: Any = None) -> Dict[str, Any]:
    """The JAX package's cost report of a compiled program
    (``cost.py:35``); always unavailable here."""
    return {"available": False, "reason": NO_COST_ANALYSIS}


def program_cost(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, Any]:
    """The JAX package's lower-and-compile cost report (``cost.py:71``);
    nothing runs and nothing is compiled: always unavailable here."""
    return executable_cost()


def leaf_nbytes(value: Any) -> int:
    """Bytes held by one state leaf (a tensor, or a list of tensors)."""
    if isinstance(value, (list, tuple)):
        return sum(leaf_nbytes(v) for v in value)
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    nbytes = getattr(value, "nbytes", None)
    return int(nbytes) if nbytes is not None else 0


def pytree_nbytes(tree: Any) -> int:
    """Total bytes across every tensor leaf of a nested dict/list/tuple."""
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    return leaf_nbytes(tree)
