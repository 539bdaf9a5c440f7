"""Core metric-state engine.

Counterpart of ``metrics_tpu/metric.py`` (the ``Metric`` base class),
limited to the eager stateful path:

* **States are tensors on the metric's device.** Every metric owns a dict of
  tensors (or lists of tensors for unbounded "cat" accumulators) on the
  device it was built for (``device=``, default ``"cuda"``), plus a
  reduction per state. Updates replace a state tensor; they never write
  into one, so a default or a state handed out stays as it was.
* **forward() is fused.** One update computes the batch-local state; the
  batch value is computed from it and the accumulated state advances by a
  merge derived from each state's reduction ("sum" -> add, "cat" -> extend,
  "max"/"min" -> elementwise). Metrics whose states do not merge (custom
  reductions) run the double-update protocol instead.
* **Sync at compute.** With a ``torch.distributed`` process group of more
  than one process, or an injected ``dist_sync_fn``, ``compute()`` gathers
  every state from every process and reduces it, then restores the local
  states. With one process nothing is gathered.
* **Pure-state calls.** :meth:`apply_update` and :meth:`apply_compute` run
  ``update``/``compute`` on a state dict handed in (``metric.py:500-563``)
  and leave the live states as they were; the keyed path vmaps them.
"""
import functools
import inspect
import os
from abc import ABC, abstractmethod
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.utilities.data import (
    _flatten,
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    resolve_device,
)
from metrics_tpu_torch.utilities.distributed import distributed_available, gather_all_tensors
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor
StateValue = Union[Tensor, List[Tensor]]
StateDict = Dict[str, StateValue]

_STR_REDUCTIONS: Dict[str, Callable] = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "cat": dim_zero_cat,
    "max": dim_zero_max,
    "min": dim_zero_min,
}

#: reductions whose per-batch state deltas can be merged into the accumulated
#: state without re-running ``update`` (enables the fused forward path);
#: list-typed states always merge by extension regardless of their reduction
_MERGEABLE_REDUCTIONS = {"sum", "cat", "max", "min"}


def _resolve_reduction(fx: Optional[Union[str, Callable]]) -> Optional[Callable]:
    if isinstance(fx, str):
        return _STR_REDUCTIONS[fx]
    return fx


def _copy_state(value: StateValue) -> StateValue:
    return list(value) if isinstance(value, list) else value.clone()


class Metric(ABC):
    """Base class of all metrics.

    Subclasses register states with :meth:`add_state` and implement
    :meth:`update` and :meth:`compute`: ``m(preds, target)`` accumulates and
    returns the batch value, ``m.compute()`` gives the epoch value with
    cross-process sync, ``m.reset()`` clears.

    Args:
        compute_on_step: if True (default) ``forward`` returns the metric value
            on the current batch; otherwise it only accumulates and returns None.
        dist_sync_on_step: synchronize state across processes on every
            ``forward`` before computing the step value.
        process_group: the ``torch.distributed`` process group the states
            sync over (default: the whole world).
        dist_sync_fn: override for the gather used at ``compute()``; receives
            one state tensor and ``group=`` and returns the per-process list.
        device: where the states live (default ``"cuda"``). Building a metric
            for a CUDA device on a machine without one raises; pass
            ``device="cpu"`` to run on the CPU. ``update``/``forward`` raise
            on input tensors that lie elsewhere.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    #: set False on subclasses whose forward must use the double-update protocol
    _fusable: bool = True

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.compute_on_step = compute_on_step
        self.dist_sync_on_step = dist_sync_on_step
        self.process_group = process_group
        self.dist_sync_fn = dist_sync_fn

        self._to_sync = True
        self._restore_cache = True
        self._computed = None
        self._forward_cache = None
        self._update_called = False

        self._defaults: Dict[str, StateValue] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Union[str, Callable]]] = {}

        self._update_signature = inspect.signature(self.update)
        self.update = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute = self._wrap_compute(self.compute)  # type: ignore[method-assign]

    # ------------------------------------------------------------------
    # state registry
    # ------------------------------------------------------------------

    def add_state(
        self,
        name: str,
        default: StateValue,
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
    ) -> None:
        """Register a state variable, accessible as ``self.<name>``.

        ``default`` is either a tensor (fixed-shape state, moved to the
        metric's device) or an empty list (unbounded accumulator of per-batch
        tensors). ``dist_reduce_fx`` is one of ``"sum" | "mean" | "cat" |
        "max" | "min" | None`` or a callable receiving the stacked
        ``(world, ...)`` gather.
        """
        is_empty_list = isinstance(default, list) and not default
        if not (isinstance(default, Tensor) or is_empty_list):
            raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        if isinstance(dist_reduce_fx, str):
            if dist_reduce_fx not in _STR_REDUCTIONS:
                raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', None]")
        elif dist_reduce_fx is not None and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', None]")

        if isinstance(default, Tensor):
            default = default.to(self.device)
        self._defaults[name] = default if isinstance(default, Tensor) else []
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        setattr(self, name, _copy_state(self._defaults[name]))

    def init_state(self) -> StateDict:
        """A fresh state dict with every state at (a copy of) its default value."""
        return {name: _copy_state(default) for name, default in self._defaults.items()}

    def _get_states(self) -> StateDict:
        return {name: getattr(self, name) for name in self._defaults}

    def _set_states(self, state: StateDict) -> None:
        for name, value in state.items():
            setattr(self, name, value)

    @contextmanager
    def _bound_state(self, state: StateDict):
        """Swap ``state`` in as the live state for the block, then restore the
        live states and the cache flags as they were (pure-call plumbing)."""
        saved = self._get_states()
        saved_flags = (self._computed, self._update_called, self._forward_cache)
        self._set_states(state)
        try:
            yield
        finally:
            self._set_states(saved)
            self._computed, self._update_called, self._forward_cache = saved_flags

    def apply_update(self, state: StateDict, *args: Any, **kwargs: Any) -> StateDict:
        """Pure update: ``state`` advanced by this batch; the live states stay
        as they were. Safe under ``torch.func.vmap``."""
        with self._bound_state({k: (list(v) if isinstance(v, list) else v) for k, v in state.items()}):
            self._unwrapped_update(*args, **kwargs)
            return self._get_states()

    def apply_compute(self, state: StateDict) -> Any:
        """Pure compute: the value of ``state``, without cross-process sync
        (``compute()`` syncs the live states first)."""
        with self._bound_state(state):
            return self._unwrapped_compute()

    def _restore_derived(self, state: StateDict) -> None:
        """Refresh Python attributes that ``update`` learns from the data
        (``Accuracy.mode``) from installed states, possibly tenant-stacked, in
        an instance that never saw a batch. Default: none."""

    def _validate_batch(self, *args: Any, **kwargs: Any) -> None:
        """The value checks of ``update`` on a whole batch. The keyed path
        runs them once before its vmapped per-row update, in which no value
        can be read to the host. Default: none."""


    def _check_input_device(self, args: Tuple, kwargs: Dict) -> None:
        """Raise on an input tensor that lies on another device than the states."""
        for value in (*args, *kwargs.values()):
            if isinstance(value, Tensor) and value.device != self.device:
                raise ValueError(
                    f"{type(self).__name__} keeps its states on {self.device}, but got an input on"
                    f" {value.device}; move the inputs to {self.device} first"
                )

    # ------------------------------------------------------------------
    # shared-update protocol (see MetricCollection._shared_deltas)
    # ------------------------------------------------------------------

    def _shared_update_key(self) -> Optional[Tuple]:
        """Hashable key identifying metrics whose per-batch update computes the
        same partial statistics (``None`` = not shareable). MetricCollection
        computes the statistics once per key and fans the deltas out.

        Opting in (returning a key) requires implementing the companion
        protocol: :meth:`_batch_deltas` (the shareable computation) and
        :meth:`_accumulate` (apply precomputed deltas to the live states)."""
        return None

    def _batch_deltas(self, *args: Any, **kwargs: Any) -> Tuple:
        """This batch's partial statistics — the shareable part of ``update``."""
        raise NotImplementedError(
            f"{self.__class__.__name__} returns a _shared_update_key but does not implement _batch_deltas"
        )

    def _accumulate(self, *deltas: Any) -> None:
        """Apply precomputed :meth:`_batch_deltas` output to the live states."""
        raise NotImplementedError(
            f"{self.__class__.__name__} returns a _shared_update_key but does not implement _accumulate"
        )

    def _update_from_deltas(self, *deltas: Any) -> None:
        """``update`` by precomputed deltas, with the same cache bookkeeping
        as the :meth:`_wrap_update` wrapper."""
        self._computed = None
        self._update_called = True
        self._accumulate(*deltas)

    def _states_mergeable(self) -> bool:
        if not self._fusable:
            return False
        for name, fx in self._reductions.items():
            if isinstance(self._defaults[name], list):
                continue  # list accumulators always merge by extension
            if fx not in _MERGEABLE_REDUCTIONS:
                return False
        return True

    def merge_states(self, a: StateDict, b: StateDict) -> StateDict:
        """Merge two state dicts according to each state's reduction."""
        merged: StateDict = {}
        for name, fx in self._reductions.items():
            va, vb = a[name], b[name]
            if isinstance(self._defaults[name], list):
                merged[name] = list(va) + list(vb)
            elif fx == "sum":
                merged[name] = va + vb
            elif fx == "max":
                merged[name] = torch.maximum(va, vb)
            elif fx == "min":
                merged[name] = torch.minimum(va, vb)
            elif fx == "cat":
                merged[name] = dim_zero_cat([va, vb])
            else:
                raise RuntimeError(f"State `{name}` with reduction {fx!r} is not mergeable")
        return merged

    # ------------------------------------------------------------------
    # stateful interface
    # ------------------------------------------------------------------

    @property
    def _unwrapped_update(self) -> Callable:
        return self.update.__wrapped__  # type: ignore[attr-defined]

    @property
    def _unwrapped_compute(self) -> Callable:
        return self.compute.__wrapped__  # type: ignore[attr-defined]

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate this batch and (if ``compute_on_step``) return its value."""
        self._check_input_device(args, kwargs)
        if self._states_mergeable():
            return self._forward_fused(*args, **kwargs)
        return self._forward_double_update(*args, **kwargs)

    def _forward_fused(self, *args: Any, _update_thunk: Optional[Callable] = None, **kwargs: Any) -> Any:
        accumulated = self._get_states()
        self._set_states(self.init_state())
        # single update pass: batch-local state (the thunk lets MetricCollection
        # substitute precomputed shared deltas for the full update)
        if _update_thunk is None:
            self._unwrapped_update(*args, **kwargs)
        else:
            _update_thunk()
        self._update_called = True
        self._computed = None

        # capture the batch-local state BEFORE compute() may sync it: merging
        # a world-reduced state into the local accumulator would double-count
        # across processes at the epoch-end sync
        batch_state = self._get_states()

        result = None
        if self.compute_on_step:
            self._to_sync = self.dist_sync_on_step
            self._restore_cache = False
            self._forward_cache = self.compute()
            result = self._forward_cache

        self._set_states(self.merge_states(accumulated, batch_state))
        self._restore_cache = True
        self._to_sync = True
        self._computed = None
        return result

    def _forward_double_update(self, *args: Any, **kwargs: Any) -> Any:
        """The double-update protocol for non-mergeable states: one update of
        the accumulated states, one of fresh states for the batch value."""
        self.update(*args, **kwargs)
        if not self.compute_on_step:
            return None

        self._to_sync = self.dist_sync_on_step
        self._restore_cache = False
        cache = self._get_states()

        self.reset()
        self.update(*args, **kwargs)
        self._forward_cache = self.compute()

        self._set_states(cache)
        self._update_called = True
        self._restore_cache = True
        self._to_sync = True
        self._computed = None
        return self._forward_cache

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            self._check_input_device(args, kwargs)
            self._computed = None
            self._update_called = True
            return update(*args, **kwargs)

        return wrapped_func

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if not self._update_called:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__}"
                    " was called before the ``update`` method which may lead to errors,"
                    " as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                return self._computed
            with self.sync_context(
                dist_sync_fn=self.dist_sync_fn,
                should_sync=self._to_sync,
                restore_cache=self._restore_cache,
            ):
                self._computed = compute(*args, **kwargs)
            return self._computed

        return wrapped_func

    # ------------------------------------------------------------------
    # cross-process sync
    # ------------------------------------------------------------------

    def _pre_sync_states(self) -> Tuple[StateDict, Dict[str, torch.dtype]]:
        """The gather-ready view of the live states, plus dtype notes.

        Concatenates every list state first, so each costs one gather and
        processes with different numbers of batches issue the same number of
        collectives. A never-updated (empty) list state takes part with a
        0-length float32 placeholder; the notes keep each non-empty list
        state's dtype so a sync in which every process was empty can restore
        it."""
        states = self._get_states()
        list_dtypes: Dict[str, torch.dtype] = {}
        for name in self._reductions:
            value = states[name]
            if isinstance(value, list):
                if value:
                    cat = dim_zero_cat(value)
                    list_dtypes[name] = cat.dtype
                    states[name] = [cat]
                else:
                    states[name] = [torch.zeros((0,), dtype=torch.float32, device=self.device)]
        return states, list_dtypes

    def _apply_gathered_states(self, gathered: StateDict, list_dtypes: Dict[str, torch.dtype]) -> None:
        """Reduce the per-process gather results into the live states (stack
        + reduction for tensor states, flatten + cat for list states, empty
        shards dropped)."""
        for name, fx in self._reductions.items():
            value = gathered[name]
            if isinstance(value[0], Tensor):
                value = torch.stack(value)
            elif isinstance(value[0], list):
                value = _flatten(value)
                # drop empty shards (processes that never updated) so the cat
                # result keeps the data's dtype/shape; keep one if all empty
                filled = [v for v in value if v.numel() > 0]
                if len(filled) < len(value):
                    value = filled or value[:1]
                if not filled and name in list_dtypes:
                    value = [v.to(list_dtypes[name]) for v in value]
            reduction_fn = _resolve_reduction(fx)
            setattr(self, name, reduction_fn(value) if reduction_fn is not None else value)

    def _sync_dist(self, dist_sync_fn: Callable = gather_all_tensors, process_group: Optional[Any] = None) -> None:
        states, list_dtypes = self._pre_sync_states()
        group = process_group or self.process_group
        gathered = apply_to_collection(states, Tensor, dist_sync_fn, group=group)
        self._apply_gathered_states(gathered, list_dtypes)

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Callable = distributed_available,
    ) -> StateDict:
        """Synchronize states across processes; returns the pre-sync local
        states (an empty dict when no sync happened)."""
        if not should_sync or not (distributed_available() or dist_sync_fn is not None):
            return {}
        if dist_sync_fn is None:
            dist_sync_fn = gather_all_tensors
        cache = self._get_states()
        self._sync_dist(dist_sync_fn, process_group=process_group)
        return cache

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        restore_cache: bool = True,
        distributed_available: Callable = distributed_available,
    ):
        """Sync states for the duration of the block, then restore the local
        (unsynced) states so accumulation can continue."""
        cache = self.sync(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )
        yield
        if cache and restore_cache:
            self._set_states(cache)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @abstractmethod
    def update(self) -> None:
        """Override to advance the metric states with a batch of inputs."""

    @abstractmethod
    def compute(self) -> Any:
        """Override to produce the final value from (synced) states."""

    def reset(self) -> None:
        """Restore every state to its default."""
        self._update_called = False
        self._forward_cache = None
        self._computed = None
        self._set_states(self.init_state())

    def clone(self) -> "Metric":
        return deepcopy(self)

    def persistent(self, mode: bool = False) -> None:
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        """Persistent states, synced across processes first so the saved
        values are aggregated over them."""
        destination = {} if destination is None else destination
        with self.sync_context(dist_sync_fn=self.dist_sync_fn):
            for key in self._defaults:
                if self._persistent[key]:
                    destination[prefix + key] = _copy_state(getattr(self, key))
        return destination

    def _should_load_from_state_dict(self) -> bool:
        # saved states are already aggregated -> only global rank 0 reloads
        if "GLOBAL_RANK" in os.environ:
            return os.environ["GLOBAL_RANK"] == "0"
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True

    def load_state_dict(self, state_dict: dict, prefix: str = "") -> None:
        for key in self._defaults:
            name = prefix + key
            if name in state_dict and self._should_load_from_state_dict():
                value = state_dict[name]
                if isinstance(value, list):
                    setattr(self, key, [torch.as_tensor(v).to(self.device) for v in value])
                else:
                    setattr(self, key, torch.as_tensor(value).to(self.device))

    # ------------------------------------------------------------------
    # misc protocol
    # ------------------------------------------------------------------

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only kwargs accepted by this metric's ``update`` signature."""
        var_kinds = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        params = self._update_signature.parameters
        filtered = {k: v for k, v in kwargs.items() if k in params and params[k].kind not in var_kinds}
        return filtered if filtered else kwargs

    def __getstate__(self) -> dict:
        # the wrapped update/compute are rebuilt on unpickling; tensors pickle
        # with their device
        return {k: v for k, v in self.__dict__.items() if k not in ("update", "compute", "_update_signature")}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._update_signature = inspect.signature(self.update)
        self.update = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute = self._wrap_compute(self.compute)  # type: ignore[method-assign]

    def __hash__(self) -> int:
        # identity-based per state object (fresh instances hash differently;
        # empty-list states don't)
        hash_vals: List[Any] = [self.__class__.__name__]
        for key in self._defaults:
            value = getattr(self, key)
            if isinstance(value, list):
                hash_vals.extend(id(v) for v in value)
            else:
                hash_vals.append(id(value))
        return hash(tuple(hash_vals))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"
