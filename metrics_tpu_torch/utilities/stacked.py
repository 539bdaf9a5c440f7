"""Stacked child states: one pure metric program over a leading replica axis.

Counterpart of ``metrics_tpu/utilities/stacked.py``, with
``torch.func.vmap`` in place of ``jax.vmap``. A wrapper that holds many
logical copies of one metric (``KeyedMetric``/``MultiTenantCollection``,
whose axis is tenants; later the bootstrapper, whose axis is replicas) keeps
them as ONE state dict whose every tensor carries an extra leading axis:

* **stack build** — :func:`stack_pytrees` (stack N concrete child states) and
  :func:`broadcast_stack` (N identical fresh copies without N inits);
* **vmapped update** — :func:`vmap_update`, the child's pure ``apply_update``
  mapped over the stack axis;
* **vmapped compute** — :func:`vmap_compute`, the child's pure
  ``apply_compute`` fanned out per stack row.

:func:`row_states` is the multi-tenant router's first half: the child's
update evaluated on every EVENT ROW of a batch independently (a vmap over the
leading event axis, each row kept as a length-1 batch so the child sees the
layout it was written for), producing per-row partial states that a segment
scatter then routes to their tenants. Inside it no value can be read to the
host (see :func:`~metrics_tpu_torch.utilities.data._is_batched`).
"""
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "broadcast_stack",
    "row_states",
    "stack_pytrees",
    "vmap_compute",
    "vmap_update",
]


def stack_pytrees(trees: Sequence[Any]) -> Any:
    """Stack equal-structure trees of tensors leaf-wise along a new leading axis."""
    return pytree.tree_map(lambda *leaves: torch.stack(leaves, dim=0), trees[0], *trees[1:])


def broadcast_stack(tree: Any, n: int) -> Any:
    """``n`` identical copies of ``tree`` stacked on a new leading axis.

    Value-identical to ``stack_pytrees([tree] * n)`` but one broadcast view
    per leaf instead of an ``n``-way stack — the cheap form for replicating a
    fresh ``init_state()`` to thousands of tenants (the views share memory;
    copy before writing into one)."""
    return pytree.tree_map(lambda leaf: torch.as_tensor(leaf).expand((n,) + tuple(leaf.shape)), tree)


def vmap_update(metric: Any, body: Optional[Callable] = None) -> Callable:
    """``torch.func.vmap`` of one child's pure update over the leading stack
    axis: ``(stacked_state, xs) -> stacked_state``. ``body(child_state, x)``
    defaults to ``metric.apply_update(child_state, *x)``."""
    if body is None:
        body = lambda s, x: metric.apply_update(s, *x)  # noqa: E731
    return torch.func.vmap(body)


def vmap_compute(metric: Any) -> Callable:
    """``torch.func.vmap`` of one child's pure compute over the leading stack
    axis: ``stacked_state -> stacked values`` (no cross-process sync)."""
    return torch.func.vmap(metric.apply_compute)


def row_states(metric: Any, args: Tuple, kwargs: Dict) -> Dict[str, Any]:
    """The child's update evaluated on every event row independently.

    Every tensor argument of rank >= 1 must share the same leading event axis
    ``B``; rank-0 tensors and python values go to every row as they are. Each
    row is presented to ``metric.apply_update`` as a length-1 batch (shape
    ``(1, ...)``), so the child runs the exact program it was written for.
    Returns the per-row batch-local states stacked to ``(B, ...)`` leaves —
    the input of a segment scatter routing rows to stacked replicas."""
    leaves, treedef = pytree.tree_flatten((args, kwargs))
    mapped = [isinstance(leaf, torch.Tensor) and leaf.ndim >= 1 for leaf in leaves]
    lengths = {int(leaf.shape[0]) for leaf, m in zip(leaves, mapped) if m}
    if not lengths:
        raise ValueError(
            "keyed update expects at least one array argument whose leading axis"
            " is the event-row axis (aligned with `tenant_ids`)"
        )
    if len(lengths) > 1:
        raise ValueError(
            "keyed update: array arguments disagree on the event-row axis"
            f" (leading axes {sorted(lengths)}); every array argument must carry"
            " the same leading row count as `tenant_ids`"
        )
    b = lengths.pop()
    # keep a length-1 batch axis per row: (B, ...) -> (B, 1, ...)
    expanded = [leaf.reshape((b, 1) + tuple(leaf.shape[1:])) if m else leaf for leaf, m in zip(leaves, mapped)]
    init = metric.init_state()

    def one(row_leaves: Tuple) -> Dict[str, Any]:
        merged = list(expanded)
        it = iter(row_leaves)
        for i, m in enumerate(mapped):
            if m:
                merged[i] = next(it)
        row_args, row_kwargs = pytree.tree_unflatten(merged, treedef)
        return metric.apply_update(init, *row_args, **row_kwargs)

    return torch.func.vmap(one)(tuple(leaf for leaf, m in zip(expanded, mapped) if m))
