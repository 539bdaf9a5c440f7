"""Stacked child states: one pure metric program over a leading replica axis.

Counterpart of ``metrics_tpu/utilities/stacked.py``, with
``torch.func.vmap`` in place of ``jax.vmap``. A wrapper that holds many
logical copies of one metric (``KeyedMetric``/``MultiTenantCollection``,
whose axis is tenants; ``BootStrapper``, whose axis is replicas) keeps
them as ONE state dict whose every tensor carries an extra leading axis:

* **stack build** — :func:`stack_pytrees` (stack N concrete child states) and
  :func:`broadcast_stack` (N identical fresh copies without N inits);
* **vmapped update** — :func:`vmap_update`, the child's pure ``apply_update``
  mapped over the stack axis;
* **vmapped compute** — :func:`vmap_compute`, the child's pure
  ``apply_compute`` fanned out per stack row.

:func:`row_states` is the multi-tenant router's first half: the child's
update evaluated on every EVENT ROW of a batch independently, producing
per-row partial states that a segment scatter then routes to their tenants.
It has two forms. A child that has a batched-rows form
(:meth:`~metrics_tpu_torch.metric.Metric._row_states`: the stat-scores
family, for inputs whose rows canonicalize alike) computes every row's state
from the whole batch at once; any other child is vmapped over the leading
event axis, each row kept as a length-1 batch so the child sees the layout it
was written for. The vmap route is the oracle of the batched form. In
neither can a value be read to the host (see
:func:`~metrics_tpu_torch.utilities.data._is_traced`).
"""
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from metrics_tpu_torch.observability.health import HEALTH, guard_rows
from metrics_tpu_torch.observability.tracing import TRACER, span
from metrics_tpu_torch.utilities.data import _counts_traces

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
    return torch.func.vmap(lambda state: metric.apply_compute(state, process_group=None))


def row_states(metric: Any, args: Tuple, kwargs: Dict) -> Dict[str, Any]:
    """The child's update evaluated on every event row independently.

    Every tensor argument of rank >= 1 must share the same leading event axis
    ``B``; rank-0 tensors and python values go to every row as they are.
    Returns the per-row batch-local states stacked to ``(B, ...)`` leaves —
    the input of a segment scatter routing rows to stacked replicas — in one
    of two forms:

    * **batched rows** — ``metric._row_states(*args, **kwargs)``, where the
      child has such a form for these inputs: the whole batch at once, equal
      bit for bit to the vmap route (the stat-scores family canonicalizes the
      batch once and counts macro rows in one launch of B1's batched entry).
      It counts in the open host request's ``rows_batched``
      (:meth:`~metrics_tpu_torch.observability.tracing.SpanTracker.note_rows_batched`);
    * **vmap** — otherwise: each row is presented to ``metric.apply_update``
      as a length-1 batch (shape ``(1, ...)``) under ``torch.func.vmap``, so
      the child runs the exact program it was written for.

    With a health policy armed every row's state is checked under
    ``metric``'s key (:func:`~metrics_tpu_torch.observability.health.guard_rows`).
    The whole is the ``row_states`` host span."""
    with span("row_states"):
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
        rows = metric._row_states(*args, **kwargs)
        if rows is not None:
            TRACER.note_rows_batched()
            if _counts_traces():
                # a capture traces the child's update once, on a row's shapes, as the vmap route does
                row_args, row_kwargs = pytree.tree_unflatten(
                    [leaf[:1] if m else leaf for leaf, m in zip(leaves, mapped)], treedef)
                metric._note_update_trace(*row_args, **row_kwargs)
        else:
            rows = _vmapped_rows(metric, leaves, mapped, treedef, b)
        if HEALTH.enabled:
            # the JAX package's guard runs inside its vmap, one check per row
            guard_rows(metric, rows, source="apply_update")
        return rows


def _vmapped_rows(metric: Any, leaves: list, mapped: list, treedef: Any, b: int) -> Dict[str, Any]:
    """The vmap route of :func:`row_states`: ``metric.apply_update`` of a
    fresh state vmapped over the rows, each a length-1 batch."""
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
