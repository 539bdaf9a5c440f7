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
  states. With one process nothing is gathered. The default gather goes
  through the active transport (``metrics_tpu_torch.transport``): the
  whole state dict in one descriptor round and one payload round
  (``utilities/distributed.py``); an injected ``dist_sync_fn`` is called
  per state.
* **Pure-state calls.** :meth:`apply_update` and :meth:`apply_compute` run
  ``update``/``compute`` on a state dict handed in (``metric.py:500-588``)
  and leave the live states as they were; the keyed path vmaps them.
  :meth:`apply_compute` syncs the state over the metric's process group
  first (:meth:`sync_state`, one collective per bucket).
* **Telemetry.** ``forward``, ``update``, ``compute``, ``reset`` and the
  epoch sync count their calls and time themselves into
  ``observability.TELEMETRY`` under :attr:`Metric.telemetry_key`, and append
  events to ``observability.EVENTS`` (``metric.py:122-140,670-673,
  1164-1211,1286-1340``). Each call site first reads the lock-free
  ``enabled`` flags, so with telemetry off no clock is read. The times are
  host times: on the card ``update`` and ``forward`` return once their work
  is enqueued, so they measure dispatch, as the JAX package's asynchronous
  dispatch does; nothing synchronizes to make them "true".
* **Observability planes** (``metric.py:537-685,921,1130-1180,1537-1600``):
  the per-update health guard after every state advance
  (``observability.set_health_policy``; off by default), the retrace
  ledger fed by every fresh capture, the sampled dispatch profiler around
  the compiled dispatches, ``metrics/<Metric>.<phase>`` profiler ranges,
  and :meth:`Metric.check_health`, :meth:`Metric.state_memory_report` and
  :meth:`Metric.cost_report`.
* **Arithmetic.** ``a + b``, ``a * 2``, ``abs(a)``, ``a[1]`` and the other
  operators build a lazy :class:`CompositionalMetric` (``metric.py:1722-1925``).
* **The compiled step** (``metric.py:596-1085``). :meth:`Metric.jit_forward`
  routes ``forward`` through a :class:`~metrics_tpu_torch.utilities.aot.CompiledDispatch`
  of the pure :meth:`apply_forward`: on the card one CUDA graph per input
  signature, replayed every step, writing the state tensors in place (the
  counterpart of the JAX package's donation); :meth:`warmup` captures it
  ahead of the first step, and :meth:`update_many` runs K stacked
  micro-batches as K updates unrolled into one graph. Inside the program no
  value is read to the host, so the value checks skip, as under a JAX trace.
  A state tensor held outside the metric takes that step through the copying
  graph, which leaves it as it was.
"""
import contextlib
import functools
import inspect
import os
import sys
import time
from abc import ABC, abstractmethod
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.observability.cost import executable_cost, leaf_nbytes, program_cost
from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.health import HEALTH, guard_state
from metrics_tpu_torch.observability.histogram import observe_dispatch
from metrics_tpu_torch.observability.profiling import PROFILER
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.observability.retrace import MONITOR, arg_signature
from metrics_tpu_torch.observability.tracing import TRACER
from metrics_tpu_torch.utilities.aot import CompiledDispatch, GraphPool, _storage_users
from metrics_tpu_torch.utilities.data import (
    _counts_traces,
    _flatten,
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    resolve_device,
    untraced_repeats,
)
from metrics_tpu_torch.utilities.distributed import (
    distributed_available,
    gather_all_tensors,
    group_label,
    sync_state_packed,
)
from metrics_tpu_torch.utilities.prints import rank_zero_warn
from metrics_tpu_torch.utilities.profiling import compiled_scope, eager_span

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

#: ``apply_compute``'s default ``process_group``: the metric's own
_GROUP_UNSET = object()

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


def _state_nbytes(states: StateDict) -> int:
    """Bytes of every tensor of ``states`` (shapes and dtypes only)."""
    return sum(t.numel() * t.element_size() for v in states.values() for t in (v if isinstance(v, list) else [v]))


#: an owner's compiled dispatches (a keyed metric's two last among them)
_DISPATCH_ATTRS = (
    "_jit_forward_fn", "_jit_forward_copy_fn", "_update_many_fn", "_update_many_copy_fn", "_keyed_update_fn",
    "_keyed_update_copy_fn",
)
#: the attributes of the compiled step that never pickle nor copy
_COMPILED_ATTRS = _DISPATCH_ATTRS + ("_graph_pool", "_donation_warned")


def _note_compiled_dispatch(obj: Any, fn: CompiledDispatch, args: Tuple, kwargs: Dict,
                            counter: str = "forward_compiled_calls") -> None:
    """Telemetry of one compiled dispatch (``metric.py:141``): count the call
    and, when it captured afresh, the compile, into the counters and the
    retrace ledger with the signature that forced it. ``warmup`` captures
    count apart (``warmup_compiles``)."""
    key = obj.telemetry_key
    TELEMETRY.inc(key, counter)
    if fn.last_compiled:
        TELEMETRY.inc(key, "jit_forward_compiles")
        MONITOR.note_compile(key, arg_signature(*args, **kwargs), count=1)


def _warmup_report(obj: Any, fn: CompiledDispatch, fresh: bool, start: float, signature: str, metric: str,
                   state_memory: Any, program: str = "forward", **extra: Any) -> Dict[str, Any]:
    """A ``warmup``'s bookkeeping (``metric.py:952``): its counters, the
    ``compile`` event, and the JAX package's report keys. The ``program``
    entry (``"forward"``, or ``"update"`` for the keyed wrappers) is the
    cost report a CUDA graph cannot give (``observability/cost.py``)."""
    key = obj.telemetry_key
    if TELEMETRY.enabled:
        TELEMETRY.inc(key, "warmup_calls")
        if fresh:
            TELEMETRY.inc(key, "warmup_compiles")
    EVENTS.record(
        "compile", key, dur_s=fn.last_compile_s, t_start=start, path="warmup", fresh=fresh,
        donated=fn.donate_state, signature=signature, **extra,
    )
    return {
        "metric": metric,
        **extra,
        "compiled_this_call": fresh,
        "compile_seconds": round(fn.last_compile_s, 6),
        "donated": fn.donate_state,
        "executables_cached": fn._cache_size(),
        "dispatch_cache": fn.cache_info(),
        program: executable_cost(),
        "state_memory": state_memory,
    }


def _note_update_many(obj: Any, start: Optional[float], submitted: Optional[float], fn: CompiledDispatch, k: int,
                      stacked: Tuple, stacked_kwargs: Dict, **payload: Any) -> None:
    """An ``update_many``'s telemetry (``metric.py:1038``): its call, its K
    batches, the host time of its submit (``start`` to ``submitted``) under
    ``dispatch_seconds{path=update_many}``, the compiled dispatch, and the
    ``scan_microbatch`` event with ``payload``. ``start`` is ``None`` while
    telemetry and events are off."""
    if start is None:
        return
    dur = submitted - start
    key = obj.telemetry_key
    if TELEMETRY.enabled:
        TELEMETRY.inc(key, "update_many_calls")
        TELEMETRY.inc(key, "update_many_batches", k)
        observe_dispatch(dur, "update_many")
        _note_compiled_dispatch(obj, fn, stacked, stacked_kwargs, counter="update_many_dispatches")
    EVENTS.record("update", key, dur_s=dur, t_start=start, path="scan_microbatch", batches=k, **payload,
                  compiled_this_call=bool(fn.last_compiled), donated=fn.donate_state)


def _microbatch_len(args: Tuple, kwargs: Dict) -> int:
    """The micro-batch count K of an ``update_many`` call (``metric.py:174``):
    the shared leading axis of every stacked tensor argument. 0-d leaves and
    python numbers broadcast to all K micro-batches and don't vote."""
    from torch.utils._pytree import tree_leaves

    lengths = set()
    for leaf in tree_leaves((args, kwargs)):
        shape = getattr(leaf, "shape", None)
        if shape is None or len(shape) == 0:
            continue
        lengths.add(int(shape[0]))
    if not lengths:
        raise ValueError(
            "update_many expects at least one stacked array argument whose leading"
            " axis is the micro-batch count K"
        )
    if len(lengths) > 1:
        raise ValueError(
            "update_many: stacked arguments disagree on the micro-batch count"
            f" (leading axes {sorted(lengths)}); every array argument must carry"
            " the same leading K"
        )
    return lengths.pop()


def _unrolled(step: Callable, state: Any, stacked: Tuple, stacked_kwargs: Dict) -> Any:
    """``state`` advanced by ``step(state, *args, **kwargs)`` once per
    micro-batch of the stacked arguments (the port's ``lax.scan``: K steps
    unrolled into one program). Leaves of rank >= 1 are sliced along their
    leading K axis; 0-d leaves and python numbers broadcast."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten((stacked, stacked_kwargs))
    for i in range(_microbatch_len(stacked, stacked_kwargs)):
        sliced = [leaf[i] if getattr(leaf, "ndim", 0) >= 1 else leaf for leaf in leaves]
        args, kwargs = tree_unflatten(sliced, spec)
        with untraced_repeats() if i else contextlib.nullcontext():
            state = step(state, *args, **kwargs)
    return state


def _aliased_leaf(state: StateDict, dispatches: Tuple, shared: Optional[Callable[[str, Tensor], int]] = None
                  ) -> Optional[str]:
    """The first leaf of the bundle ``state`` (the owner's ``_get_states()``)
    that something outside its owner holds — the object itself, by its
    reference count (``metric.py:866``), or its storage, through a view —
    else ``None``. Expected references: the owner's attribute, ``state``,
    the loop variable, ``getrefcount``'s argument, the owner's compiled
    dispatches' entries, and ``shared(name, leaf)`` more (members of a group
    pointing at the same tensor)."""
    for name in state:
        v = state[name]
        if not isinstance(v, Tensor):
            continue  # list states never reach the compiled path (the gate)
        expected = 4 + sum(d.refs(v) for d in dispatches if d is not None)
        if shared is not None:
            expected += shared(name, v)
        if sys.getrefcount(v) > expected or _storage_users(v) > 1:
            return name
    return None


def _observed_forward(obj: Any, counter: str, thunk: Callable) -> Any:
    """Run one forward under telemetry: path counter + host wall-time
    histogram + event (``metric.py:122-140``)."""
    if not (TELEMETRY.enabled or EVENTS.enabled):
        return thunk()
    start = time.perf_counter()
    try:
        return thunk()
    finally:
        dur = time.perf_counter() - start
        key = obj.telemetry_key
        TELEMETRY.record_call(key, counter, "forward", dur)
        EVENTS.record("forward", key, dur_s=dur, t_start=start, path=counter)


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
        process_group: the group the states sync over at ``compute()``:
            ``None`` (the whole world), a ``torch.distributed`` process group,
            or a collection of global ranks (the rounds span the world, only
            those ranks' states enter the result).
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
    #: the compiled step (:meth:`jit_forward`): off until asked for
    _jit_forward_enabled: bool = False
    _jit_forward_donate: bool = True
    _jit_forward_fn: Optional[CompiledDispatch] = None
    _jit_forward_copy_fn: Optional[CompiledDispatch] = None
    _update_many_fn: Optional[CompiledDispatch] = None
    _update_many_copy_fn: Optional[CompiledDispatch] = None
    #: appended to the unbounded-list refusal of the compiled step
    _sketch_hint: str = ""

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
        self._buffers: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Union[str, Callable]]] = {}

        self._update_signature = inspect.signature(self.update)
        self.update = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute = self._wrap_compute(self.compute)  # type: ignore[method-assign]

    def set_transport(self, transport: Optional[Any]) -> "Metric":
        """Pin this metric to a transport (``metrics_tpu_torch.transport``);
        ``None`` restores the ambient one. A pinned metric syncs itself and
        stays out of its collection's packed sync. Returns ``self``."""
        if transport is not None:
            from metrics_tpu_torch.transport import Transport

            if not isinstance(transport, Transport):
                raise TypeError(f"expected a metrics_tpu_torch.transport.Transport, got {transport!r}")
        self.__dict__["_transport"] = transport
        return self

    @property
    def transport(self) -> Optional[Any]:
        """This metric's pinned transport (``None``: the ambient one)."""
        return self.__dict__.get("_transport")

    def _resolve_transport(self) -> Any:
        from metrics_tpu_torch.transport import resolve_transport

        return resolve_transport(self)

    @property
    def telemetry_key(self) -> str:
        """Stable per-instance telemetry key (``"<Class>#<ordinal>"``), under
        which this metric's counters and timers appear in
        ``observability.snapshot()``. Assigned at first use; clones and
        unpickled copies get fresh keys (their counters start at zero)."""
        key = self.__dict__.get("_telemetry_key")
        if key is None:
            key = TELEMETRY.register(self)
            self._telemetry_key = key
        return key

    # ------------------------------------------------------------------
    # state registry
    # ------------------------------------------------------------------

    def add_state(
        self,
        name: str,
        default: StateValue,
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
        buffer: bool = False,
    ) -> None:
        """Register a state variable, accessible as ``self.<name>``.

        ``default`` is either a tensor (fixed-shape state, moved to the
        metric's device) or an empty list (unbounded accumulator of per-batch
        tensors). ``dist_reduce_fx`` is one of ``"sum" | "mean" | "cat" |
        "max" | "min" | None`` or a callable receiving the stacked
        ``(world, ...)`` gather. ``buffer=True`` pins the state's persistence:
        :meth:`persistent` leaves it as registered (the binned curves'
        ``thresholds``, always saved).
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
        self._buffers[name] = buffer
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
        as they were. Safe under ``torch.func.vmap`` and inside a compiled
        program, where its capture counts ``update_traces``."""
        self._note_update_trace(*args, **kwargs)
        with compiled_scope(f"{self.__class__.__name__}.update"):
            with self._bound_state({k: (list(v) if isinstance(v, list) else v) for k, v in state.items()}):
                self._unwrapped_update(*args, **kwargs)
                new_state = self._get_states()
        if HEALTH.enabled:
            guard_state(self, new_state, source="apply_update")
        return new_state

    def _note_update_trace(self, *args: Any, **kwargs: Any) -> None:
        """Count a compiled capture's trace of this update (``update_traces``
        and the retrace ledger's signature of ``args``)."""
        if TELEMETRY.enabled and _counts_traces():
            TELEMETRY.inc(self.telemetry_key, "update_traces")
            MONITOR.note_trace(self.telemetry_key, arg_signature(*args, **kwargs))

    def apply_compute(self, state: StateDict, process_group: Any = _GROUP_UNSET) -> Any:
        """Pure compute: the value of ``state``, synced over ``process_group``
        first (default: the metric's own; ``None``: no sync). The packed sync
        needs a ``torch.distributed`` ``ProcessGroup``: a collection of ranks
        raises, on every process alike."""
        if process_group is _GROUP_UNSET:
            process_group = self.process_group
        if TELEMETRY.enabled and _counts_traces():
            TELEMETRY.inc(self.telemetry_key, "compute_traces")
        with compiled_scope(f"{self.__class__.__name__}.compute"):
            state = self.sync_state(state, process_group)
            with self._bound_state(state):
                return self._unwrapped_compute()

    def apply_forward(
        self,
        state: StateDict,
        *args: Any,
        process_group: Any = _GROUP_UNSET,
        batch_state: Optional[StateDict] = None,
        **kwargs: Any,
    ) -> Tuple[StateDict, Any]:
        """Pure forward (``metric.py:596``): ``(accumulated state, batch
        value)`` in one update pass. The value is this batch's alone, synced
        over ``process_group`` only with ``dist_sync_on_step``; ``batch_state``
        lets a collection hand in the batch-local state of a shared update."""
        if process_group is _GROUP_UNSET:
            process_group = self.process_group
        if batch_state is None:
            batch_state = self.apply_update(self.init_state(), *args, **kwargs)
        value = self.apply_compute(batch_state, process_group=process_group if self.dist_sync_on_step else None)
        if self._states_mergeable():
            new_state = self.merge_states(state, batch_state)
            # the merged accumulator never passes apply_update's guard
            if HEALTH.enabled:
                guard_state(self, new_state, source="apply_forward")
        else:
            new_state = self.apply_update(state, *args, **kwargs)
        return new_state, value

    def _apply_accumulate(self, state: StateDict, deltas: Tuple) -> StateDict:
        """Pure analogue of :meth:`_accumulate`: ``state`` advanced by
        precomputed shared deltas."""
        with compiled_scope(f"{self.__class__.__name__}.update"):
            with self._bound_state({k: (list(v) if isinstance(v, list) else v) for k, v in state.items()}):
                self._accumulate(*deltas)
                new_state = self._get_states()
        if HEALTH.enabled:
            guard_state(self, new_state, source="apply_update")
        return new_state

    def sync_state(self, state: StateDict, process_group: Any) -> StateDict:
        """``state`` synced over ``process_group`` (a ``torch.distributed``
        ``ProcessGroup``) with one collective per (reduction, dtype) bucket
        and one pair of gather rounds for the ``"cat"``/``None`` leaves
        (:func:`~metrics_tpu_torch.utilities.distributed.sync_state_packed`);
        ``None`` returns it as it is."""
        if process_group is None:
            return state
        with compiled_scope(f"{self.__class__.__name__}.sync"):
            return sync_state_packed(state, self._reductions, process_group)

    def _restore_derived(self, state: StateDict) -> None:
        """Refresh Python attributes that ``update`` learns from the data
        (``Accuracy.mode``) from installed states, possibly tenant-stacked, in
        an instance that never saw a batch. Default: none."""

    def _validate_batch(self, *args: Any, **kwargs: Any) -> None:
        """The value checks of ``update`` on a whole batch. The keyed path
        runs them once before its per-row states, in which no value can be
        read to the host. Default: none."""

    def _row_states(self, *args: Any, **kwargs: Any) -> Optional[StateDict]:
        """The batched-rows form of the keyed path's per-row states: for a
        batch whose tensor arguments share the leading row axis ``B``, the
        state of a fresh update on each row alone as a length-1 batch,
        stacked to ``(B, ...)`` leaves, computed without the vmap and reading
        no value, or ``None`` where this metric has no such form for these
        inputs (:func:`~metrics_tpu_torch.utilities.stacked.row_states` then
        vmaps :meth:`apply_update`). Default: ``None``."""
        return None


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
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "update_calls")
        if EVENTS.enabled:
            EVENTS.record("update", self.telemetry_key, path="shared_deltas")
        self._accumulate(*deltas)
        if HEALTH.enabled:
            guard_state(self, self._get_states(), source="update")

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
        with eager_span(f"{self.__class__.__name__}.forward"):
            if self._jit_forward_enabled:
                return self._forward_jitted(*args, **kwargs)
            if self._states_mergeable():
                return _observed_forward(self, "forward_fused_calls", lambda: self._forward_fused(*args, **kwargs))
            return _observed_forward(
                self, "forward_double_update_calls", lambda: self._forward_double_update(*args, **kwargs)
            )

    # -- the compiled step ----------------------------------------------------

    def jit_forward(self, enable: bool = True, donate: bool = True) -> "Metric":
        """Route the stateful ``forward`` through one compiled program (opt-in;
        ``metric.py:749``).

        The eager ``m(preds, target)`` launches each operation from the host
        and reads the targets' range to the host for its value checks:
        host-bound, a few milliseconds per step. After ``m.jit_forward()`` the
        same call runs the pure :meth:`apply_forward` through a
        :class:`~metrics_tpu_torch.utilities.aot.CompiledDispatch`: on the card
        a CUDA graph per input signature, captured at its first call (or by
        :meth:`warmup`) and replayed after, with no synchronizing call::

            acc = Accuracy().jit_forward()
            acc.warmup(preds0, target0)          # optional: capture now
            for preds, target in loader:
                batch_acc = acc(preds, target)   # one replay
            acc.compute()                        # epoch sync as usual

        The graph writes the state tensors in place (``donate=True``, the
        counterpart of the JAX package's donation); a state tensor held
        outside the metric (a kept handle to ``m.some_state``, or a view of
        it) takes that step through the copying graph instead, which leaves
        it as it was, with a one-shot warning (``jit_forward_alias_fallbacks``).
        ``donate=False`` always copies.

        The trades, as under a JAX trace: the value checks skip (shape and
        dtype errors still raise), every new input shape pays one capture,
        and what the eager path infers from input values must be given:
        integer label predictions need ``num_classes=``. Python ``bool`` and
        string arguments are static (one graph per value). Refused
        (``ValueError``) for unbounded list states (use the
        ``capacity=``/``sketched=True`` modes) and for ``dist_sync_on_step``.
        """
        if not enable:
            self._jit_forward_enabled = False
            self._drop_compiled_dispatch()
            return self
        self._jit_forward_gate()
        self._jit_forward_enabled = True
        self._jit_forward_donate = bool(donate)
        self._drop_compiled_dispatch()
        return self

    def _drop_compiled_dispatch(self) -> None:
        """Drop every captured program (donation flag changed, enablement
        toggled, unpickled or cloned copy)."""
        for name in ("_jit_forward_fn", "_jit_forward_copy_fn", "_update_many_fn", "_update_many_copy_fn"):
            self.__dict__[name] = None

    def _compiled_state_gate(self) -> None:
        """Raise ``ValueError`` if the state cannot thread a compiled program
        (``metric.py:812``); side-effect free, so a collection can check its
        members without touching their own enablement."""
        if any(isinstance(v, list) for v in self._defaults.values()):
            hint = f" {self._sketch_hint}" if self._sketch_hint else ""
            raise ValueError(
                f"{self.__class__.__name__} holds unbounded list states, whose pytree grows"
                " every step under jit (a retrace per call); use the fixed-shape"
                " `capacity=`/`streaming=` mode of this metric with jit_forward, or keep the"
                f" eager forward.{hint}"
            )
        if set(self.init_state()) != set(self._defaults):
            raise ValueError(
                f"{self.__class__.__name__} overrides the pure-state protocol (its init_state"
                " keys differ from the registered states), so its stateful forward cannot be"
                " jitted generically; jit a function over its pure apply_update/apply_compute"
                " API instead."
            )

    def _jit_forward_gate(self) -> None:
        """:meth:`_compiled_state_gate` plus the forward-only refusal."""
        self._compiled_state_gate()
        if self.dist_sync_on_step:
            raise ValueError(
                "jit_forward cannot trace the eager on-step gather of dist_sync_on_step=True;"
                " use apply_forward with a mesh axis for compiled on-step sync."
            )

    def _pool(self) -> GraphPool:
        """The memory pool every graph of this metric shares."""
        pool = self.__dict__.get("_graph_pool")
        if pool is None:
            pool = self.__dict__["_graph_pool"] = GraphPool()
        return pool

    def _dispatches(self) -> Tuple:
        return tuple(self.__dict__.get(n) for n in _DISPATCH_ATTRS)

    def _dispatch_refs(self, t: Tensor) -> int:
        """References to ``t`` held by every compiled dispatch of this metric."""
        return sum(d.refs(t) for d in self._dispatches() if d is not None)

    def _forward_program(self, state: StateDict, *args: Any, **kwargs: Any) -> Tuple[StateDict, Any]:
        if self.compute_on_step:
            return self.apply_forward(state, *args, process_group=None, **kwargs)
        return self.apply_update(state, *args, **kwargs), None

    def _forward_dispatch(self, donate: bool) -> CompiledDispatch:
        name = "_jit_forward_fn" if donate else "_jit_forward_copy_fn"
        fn = self.__dict__.get(name)
        if fn is None:
            fn = CompiledDispatch(self._forward_program, donate_state=donate, pool=self._pool(),
                                  owner_refs=self._dispatch_refs)
            self.__dict__[name] = fn
        return fn

    def _donation_safe_state(self, state: StateDict) -> Tuple[StateDict, bool]:
        """``(state, True)`` when the compiled step may write ``state`` in
        place; ``(state, False)`` when a leaf is held outside the metric
        (``metric.py:866``): that step then takes the copying graph, with a
        one-shot warning. (The JAX package also copies a leaf that is the
        registered default; the port's states are always copies of theirs.)"""
        aliased = _aliased_leaf(state, self._dispatches())
        if aliased is None:
            return state, True
        self._note_alias_fallback(aliased)
        return state, False

    def _note_alias_fallback(self, aliased: str) -> None:
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "jit_forward_alias_fallbacks")
        if not self.__dict__.get("_donation_warned", False):
            self._donation_warned = True
            rank_zero_warn(
                f"{self.__class__.__name__}.jit_forward: state `{aliased}` is referenced"
                " outside the metric, so this step dispatches through the copying"
                " graph instead of writing the state tensors in place (which would"
                " change the external handle). Drop external references to metric"
                " states to restore in-place updates, or call jit_forward(donate=False)"
                " to keep the copying path silently.",
                UserWarning,
            )

    def _forward_jitted(self, *args: Any, **kwargs: Any) -> Any:
        # a cached compute() result may be a state tensor: cleared BEFORE the
        # alias check, so it cannot be written under a caller holding it
        self._computed = None
        self._forward_cache = None
        state = self._get_states()
        donatable = False
        if self._jit_forward_donate:
            state, donatable = self._donation_safe_state(state)
        fn = self._forward_dispatch(donatable)
        prof = PROFILER.begin("compiled", self.device)
        start = time.perf_counter() if (EVENTS.enabled or TELEMETRY.enabled) else None
        new_state, value = fn(state, *args, **kwargs)
        submitted = time.perf_counter() if (start is not None or prof is not None) else None
        if prof is not None:
            PROFILER.finish(prof, self.telemetry_key, fn, submit_end=submitted)
        if start is not None:
            # host time of the dispatch (a replay is enqueued, not waited for)
            dur = submitted - start
            if TELEMETRY.enabled:
                observe_dispatch(dur, "compiled")
            EVENTS.record(
                "forward", self.telemetry_key, dur_s=dur, t_start=start, path="compiled",
                compiled_this_call=bool(fn.last_compiled), donated=fn.donate_state,
            )
        if TELEMETRY.enabled:
            _note_compiled_dispatch(self, fn, args, kwargs)
        self._set_states(new_state)
        self._update_called = True
        self._computed = None
        self._forward_cache = value
        return value

    def warmup(self, *sample_batch: Any, **kwargs: Any) -> Dict[str, Any]:
        """Capture the ``jit_forward`` program for this batch's signature
        ahead of the first step (``metric.py:952``): the state does not
        change, a ``compile`` event is recorded, and the first real step is a
        replay. Enables :meth:`jit_forward` if it is not enabled (the same
        refusals). Returns the JAX package's report keys; ``compile_seconds``
        is the capture's wall time."""
        if not self._jit_forward_enabled:
            self.jit_forward(donate=self._jit_forward_donate)
        self._check_input_device(sample_batch, kwargs)
        fn = self._forward_dispatch(self._jit_forward_donate)
        start = time.perf_counter()
        fresh = fn.warm(self._get_states(), *sample_batch, **kwargs)
        return _warmup_report(self, fn, fresh, start, arg_signature(*sample_batch, **kwargs), type(self).__name__,
                              self.state_memory_report())

    # -- K micro-batches in one program ----------------------------------------

    def _scan_update_many(self, state: StateDict, stacked: Tuple, stacked_kwargs: Dict) -> Tuple[StateDict, Any]:
        """Pure K-micro-batch update (``metric.py:1012``): K
        :meth:`apply_update` steps unrolled into one program."""
        return _unrolled(self.apply_update, state, stacked, stacked_kwargs), None

    def _update_many_dispatch(self, donatable: bool) -> CompiledDispatch:
        donate = donatable and self._jit_forward_donate
        name = "_update_many_fn" if donate else "_update_many_copy_fn"
        fn = self.__dict__.get(name)
        if fn is None:
            fn = CompiledDispatch(self._scan_update_many, donate_state=donate, pool=self._pool(),
                                  owner_refs=self._dispatch_refs)
            self.__dict__[name] = fn
        return fn

    def update_many(self, *stacked: Any, **stacked_kwargs: Any) -> None:
        """Accumulate K stacked micro-batches in ONE compiled dispatch
        (``metric.py:1038``): every tensor argument carries a leading axis of
        K, and the call equals K ``update`` calls, run as one CUDA graph of K
        unrolled updates over the state (written in place, as by
        :meth:`jit_forward`; ``donate=False`` there copies here too). 0-d
        leaves and python numbers broadcast to every micro-batch; ``bool``
        flags are static. Works with or without :meth:`jit_forward`; the
        same refusals apply."""
        self._dispatch_update_many(stacked, stacked_kwargs)

    def _begin_update_many(self, stacked: Tuple, stacked_kwargs: Dict) -> int:
        """:meth:`update_many`'s refusals and cache clears before its
        dispatch; returns K."""
        self._compiled_state_gate()
        self._check_input_device(stacked, stacked_kwargs)
        k = _microbatch_len(stacked, stacked_kwargs)
        # a cached compute() result may be a state tensor: cleared before the
        # alias check, so it cannot be written under a caller holding it
        self._computed = None
        self._forward_cache = None
        return k

    def _dispatch_update_many(self, stacked: Tuple, stacked_kwargs: Dict) -> Any:
        """:meth:`update_many`'s body; returns the program's extra output."""
        k = self._begin_update_many(stacked, stacked_kwargs)
        state = self._get_states()
        donatable = True
        if self._jit_forward_donate:
            state, donatable = self._donation_safe_state(state)
        fn = self._update_many_dispatch(donatable)
        prof = PROFILER.begin("update_many", self.device)
        start = time.perf_counter() if (TELEMETRY.enabled or EVENTS.enabled) else None
        new_state, extra = fn(state, stacked, stacked_kwargs)
        submitted = time.perf_counter() if (start is not None or prof is not None) else None
        if prof is not None:
            PROFILER.finish(prof, self.telemetry_key, fn, submit_end=submitted)
        _note_update_many(self, start, submitted, fn, k, stacked, stacked_kwargs)
        self._set_states(new_state)
        self._update_called = True
        self._computed = None
        return extra

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
        if HEALTH.enabled:
            # the accumulator after the merge: under "raise" this forward raises
            guard_state(self, self._get_states(), source="forward")
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
            observed = TELEMETRY.enabled or EVENTS.enabled
            if not observed and not HEALTH.enabled:
                return update(*args, **kwargs)
            start = time.perf_counter() if observed else 0.0
            try:
                result = update(*args, **kwargs)
            finally:
                if observed:
                    dur = time.perf_counter() - start
                    key = self.telemetry_key
                    TELEMETRY.record_call(key, "update_calls", "update", dur)
                    EVENTS.record("update", key, dur_s=dur, t_start=start)
            if HEALTH.enabled:
                guard_state(self, self._get_states(), source="update")
            return result

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
            if TELEMETRY.enabled:
                TELEMETRY.inc(self.telemetry_key, "compute_calls")
            HEALTH.drain()
            if self._computed is not None:
                return self._computed
            start = time.perf_counter() if (TELEMETRY.enabled or EVENTS.enabled) else None
            with self.sync_context(
                dist_sync_fn=self.dist_sync_fn,
                should_sync=self._to_sync,
                restore_cache=self._restore_cache,
            ):
                self._computed = compute(*args, **kwargs)
            if start is not None:
                dur = time.perf_counter() - start
                TELEMETRY.observe(self.telemetry_key, "compute", dur)
                EVENTS.record("compute", self.telemetry_key, dur_s=dur, t_start=start)
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

    def _apply_gathered_states(
        self, gathered: StateDict, list_dtypes: Dict[str, torch.dtype], presynced: Optional[StateDict] = None
    ) -> None:
        """Reduce the per-process gather results into the live states (stack
        + reduction for tensor states, flatten + cat for list states, empty
        shards dropped). ``presynced`` holds leaves the transport already
        reduced; they are set as they are."""
        for name, fx in self._reductions.items():
            if presynced is not None and name in presynced:
                setattr(self, name, presynced[name])
                continue
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

    def _note_sync_telemetry(self, states: StateDict) -> Optional[int]:
        """Per-metric sync counters; returns the payload byte count (``None``
        when nothing records)."""
        if not (TELEMETRY.enabled or EVENTS.enabled):
            return None
        payload_bytes = _state_nbytes(states)
        if TELEMETRY.enabled:
            key = self.telemetry_key
            TELEMETRY.inc(key, "sync_calls")
            TELEMETRY.inc(key, "sync_payload_bytes", payload_bytes)
        return payload_bytes

    def _sync_dist(self, dist_sync_fn: Callable = gather_all_tensors, process_group: Optional[Any] = None) -> None:
        states, list_dtypes = self._pre_sync_states()
        payload_bytes = self._note_sync_telemetry(states)
        sync_start = time.perf_counter() if EVENTS.enabled else None
        group = process_group or self.process_group
        # one span around the epoch sync: a deterministic id shared by every
        # participating process
        span = TRACER.begin("sync", group=group_label(group), bucket="metric") if TRACER.enabled else None
        presynced = None
        if dist_sync_fn is gather_all_tensors:
            # the default: the transport may reduce some leaves in place, and
            # the rest rides one descriptor round and one payload round
            transport = self._resolve_transport()
            presynced = transport.reduce_states(states, self._reductions, group=group)
            rest = {k: v for k, v in states.items() if k not in (presynced or {})}
            gathered = transport.gather_pytrees([rest], group=group)[0] if rest else {}
        else:
            # an injected gather keeps its per-state contract
            gathered = apply_to_collection(states, Tensor, dist_sync_fn, group=group)
        span_id = TRACER.end(span, metric=self.telemetry_key) if span else None
        if sync_start is not None:
            EVENTS.record(
                "sync",
                self.telemetry_key,
                dur_s=time.perf_counter() - sync_start,
                t_start=sync_start,
                payload_bytes=payload_bytes,
                span_id=span_id,
            )
        self._apply_gathered_states(gathered, list_dtypes, presynced)

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

    def compute_async(
        self,
        *,
        on_degraded: str = "retry",
        round_timeout_s: Optional[float] = None,
        max_retries: Optional[int] = None,
        backoff_s: Optional[float] = None,
    ) -> Any:
        """Epoch-end compute with the cross-process gather off the caller's
        path (``metric.py:1380``).

        Clones the live states on the caller's thread (a real copy: on the
        card the copies are enqueued on the caller's stream, after the
        updates they snapshot) and hands the clone's ``compute()`` to the
        background engine (:mod:`metrics_tpu_torch.utilities.async_sync`).
        Returns a :class:`~metrics_tpu_torch.utilities.async_sync.SyncFuture`
        whose ``result()`` is what :meth:`compute` at the snapshot would have
        returned; later updates of the live metric do not change it.
        ``on_degraded``/``round_timeout_s``/``max_retries``/``backoff_s``
        select the policy for a round that raises or times out. Every process
        must submit the same ``compute_async`` calls in the same order, as
        for ``compute()``.
        """
        from metrics_tpu_torch.utilities.async_sync import compute_async

        return compute_async(
            self, on_degraded=on_degraded, round_timeout_s=round_timeout_s, max_retries=max_retries,
            backoff_s=backoff_s,
        )

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
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "reset_calls")
        self._update_called = False
        self._forward_cache = None
        self._computed = None
        self.__dict__.pop("_loaded_state", None)
        self._set_states(self.init_state())

    def clone(self) -> "Metric":
        return deepcopy(self)

    def keyed(self, num_tenants: int, **kwargs: Any) -> "Metric":
        """An N-tenant stacked view of this metric (``metric.py:1475``): a
        :class:`~metrics_tpu_torch.wrappers.multitenant.KeyedMetric` holding
        the state of ``num_tenants`` logical streams on a leading tenant axis,
        advanced by one segment-scatter update per batch, on this metric's
        device unless ``device=`` says otherwise. The keyed state starts at
        the defaults (this instance's accumulated state is not inherited)."""
        from metrics_tpu_torch.wrappers.multitenant import KeyedMetric

        kwargs.setdefault("device", self.device)
        return KeyedMetric(self, num_tenants, **kwargs)

    def persistent(self, mode: bool = False) -> None:
        for key in self._persistent:
            if not self._buffers[key]:
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
                # a collection's compiled step may group this metric only after a value check
                self.__dict__["_loaded_state"] = True

    # ------------------------------------------------------------------
    # observability reports
    # ------------------------------------------------------------------

    def check_health(self, state: Optional[StateDict] = None) -> Dict[str, Any]:
        """Numerical health report of ``state`` (default: the live states;
        ``metric.py:1537``): per-state NaN/Inf element counts plus the zero
        total-weight flag of mean-style denominators. Works at any health
        policy; an explicit check never raises or warns, but an unhealthy
        result records a ``health`` event and the ``health_events`` counter.
        Reads the states to the host. The automatic per-update guard is
        armed with ``observability.set_health_policy``."""
        from metrics_tpu_torch.observability.health import check_state

        return check_state(self, self._get_states() if state is None else state)

    def state_memory_report(self) -> Dict[str, Any]:
        """Bytes held by each registered state right now (``metric.py:1554``),
        from tensor metadata (no read from the card). List accumulators
        report their element count beside the summed bytes."""
        per_state: Dict[str, Any] = {}
        total = 0
        for name in self._defaults:
            value = getattr(self, name)
            nbytes = leaf_nbytes(value)
            entry: Dict[str, Any] = {"bytes": int(nbytes)}
            if isinstance(value, list):
                entry["elements"] = len(value)
            per_state[name] = entry
            total += nbytes
        return {"per_state": per_state, "total_bytes": int(total)}

    def cost_report(self, *example_batch: Any, **kwargs: Any) -> Dict[str, Any]:
        """The JAX package's cost report keys (``metric.py:1575``): its
        ``update`` and ``compute`` entries read XLA's cost analysis, which a
        CUDA graph has none of, so they say so
        (:mod:`~metrics_tpu_torch.observability.cost`); nothing runs.
        ``state_memory`` is :meth:`state_memory_report`."""
        return {
            "metric": type(self).__name__,
            "update": program_cost(self.apply_update, self.init_state(), *example_batch, **kwargs),
            "state_memory": self.state_memory_report(),
            "compute": program_cost(self.apply_compute),
        }

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
        # captured graphs never pickle nor copy: the copy captures its own
        return {
            k: v
            for k, v in self.__dict__.items()
            if k not in ("update", "compute", "_update_signature", "_telemetry_key", *_COMPILED_ATTRS)
        }

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


class CompositionalMetric(Metric):
    """Lazy composition of two metrics under an operator, evaluated at compute().

    Counterpart of ``metrics_tpu/metric.py:1722-1867``. ``update`` fans out
    to both children with per-child keyword filtering; ``compute`` applies
    ``op`` to the child results; sync is a no-op here, because each child
    syncs itself. The composition owns no state, so ``forward`` takes the
    double-update protocol (``_fusable = False``): each child runs its own
    update, and a composition of two stat-scores metrics counts its batch
    twice where a collection's shared update counts it once. Its reset
    resets the children, so a ``forward`` leaves them holding the last
    batch only, as the reference's forward does.
    """

    _fusable = False  # children own the state; use the double-update forward

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, int, float, Tensor],
        metric_b: Union[Metric, int, float, Tensor, None],
    ) -> None:
        operands = (metric_a, metric_b)
        device = next((m.device for m in operands if isinstance(m, Metric)), None)
        if device is None:
            device = next((m.device for m in operands if isinstance(m, Tensor)), "cpu")
        super().__init__(device=device)
        self.op = operator
        self.metric_a = metric_a
        self.metric_b = metric_b

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        pass  # children sync themselves

    def jit_forward(self, enable: bool = True, donate: bool = True) -> "Metric":
        """Refused with the JAX package's error: the children own the state,
        so no compiled forward can thread it. ``enable=False`` is a no-op."""
        if enable:
            self._compiled_state_gate()
        return self

    def _compiled_state_gate(self) -> None:
        """Every compiled path (``jit_forward``, ``warmup``, ``update_many``)
        is refused, as in the JAX package."""
        raise ValueError(
            "CompositionalMetric cannot jit its forward (children own the state); call"
            " jit_forward() on the child metrics, or jit a function over their pure API."
        )

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def check_health(self, state: Optional[StateDict] = None) -> Dict[str, Any]:
        """The children's health reports (``metric.py:1785``), keyed like the
        pure-state layout, an aliased child checked once."""
        state = state or {}
        children: Dict[str, Any] = {}
        if isinstance(self.metric_a, Metric):
            children["a"] = self.metric_a.check_health(state.get("a"))
        if isinstance(self.metric_b, Metric) and self.metric_b is not self.metric_a:
            children["b"] = self.metric_b.check_health(state.get("b"))
        return {
            "metric": self.telemetry_key,
            "healthy": all(c["healthy"] for c in children.values()),
            "children": children,
        }

    def state_memory_report(self) -> Dict[str, Any]:
        """The children's state bytes (``metric.py:1800``), keyed like the
        pure-state layout, an aliased child counted once."""
        report: Dict[str, Any] = {"per_state": {}, "total_bytes": 0}
        if isinstance(self.metric_a, Metric):
            sub = self.metric_a.state_memory_report()
            report["per_state"]["a"] = sub
            report["total_bytes"] += sub["total_bytes"]
        if isinstance(self.metric_b, Metric) and self.metric_b is not self.metric_a:
            sub = self.metric_b.state_memory_report()
            report["per_state"]["b"] = sub
            report["total_bytes"] += sub["total_bytes"]
        return report

    # pure API: child states keyed "a"/"b" (an aliased child, ``m + m``,
    # holds one state "a" that advances twice per step, as the eager update
    # does)

    def init_state(self) -> StateDict:
        state: StateDict = {}
        if isinstance(self.metric_a, Metric):
            state["a"] = self.metric_a.init_state()
        if isinstance(self.metric_b, Metric) and self.metric_b is not self.metric_a:
            state["b"] = self.metric_b.init_state()
        return state

    def apply_update(self, state: StateDict, *args: Any, **kwargs: Any) -> StateDict:
        new_state: StateDict = {}
        if isinstance(self.metric_a, Metric):
            new_state["a"] = self.metric_a.apply_update(state["a"], *args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            if self.metric_b is self.metric_a:
                new_state["a"] = self.metric_a.apply_update(
                    new_state["a"], *args, **self.metric_a._filter_kwargs(**kwargs)
                )
            else:
                new_state["b"] = self.metric_b.apply_update(
                    state["b"], *args, **self.metric_b._filter_kwargs(**kwargs)
                )
        return new_state

    def apply_compute(self, state: StateDict, process_group: Any = _GROUP_UNSET) -> Any:
        # forwarded as given: unset, each child syncs over its own group
        val_a = (
            self.metric_a.apply_compute(state["a"], process_group=process_group)
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        if isinstance(self.metric_b, Metric):
            val_b = (
                val_a
                if self.metric_b is self.metric_a
                else self.metric_b.apply_compute(state["b"], process_group=process_group)
            )
        else:
            val_b = self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def __repr__(self) -> str:
        _op_name = getattr(self.op, "__name__", repr(self.op))
        return f"{self.__class__.__name__}(\n  {_op_name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"


def _binary_op(fn: Callable) -> Callable:
    """``fn`` over two operands, a number among them made a tensor on the
    other's device (torch's binary functions take a tensor first)."""

    @functools.wraps(fn)
    def op(a: Any, b: Any) -> Tensor:
        if not isinstance(a, Tensor):
            a = torch.as_tensor(a, device=b.device if isinstance(b, Tensor) else None)
        if not isinstance(b, Tensor):
            b = torch.as_tensor(b, device=a.device)
        return fn(a, b)

    return op


def _neg(value: Tensor) -> Tensor:
    return -torch.abs(value)


def _install_operators() -> None:
    """Attach the arithmetic, bitwise and comparison operators that build
    lazy compositions (``metric.py:1869-1925``): 11 binary operators and
    their reflected forms, 6 comparisons, ``abs``, ``+``/``-`` (which the
    reference maps to ``abs`` and ``-abs``), ``~`` and indexing. ``//`` is
    ``torch.floor_divide`` and ``%`` is ``torch.fmod`` (the sign of the
    dividend), the reference's own functions."""

    def binary(op: Callable, swap: bool = False) -> Callable:
        def method(self: Metric, other: Any) -> CompositionalMetric:
            if swap:
                return CompositionalMetric(op, other, self)
            return CompositionalMetric(op, self, other)

        return method

    def unary(op: Callable) -> Callable:
        def method(self: Metric) -> CompositionalMetric:
            return CompositionalMetric(op, self, None)

        return method

    binary_table = {
        "add": torch.add,
        "sub": torch.sub,
        "mul": torch.mul,
        "truediv": torch.true_divide,
        "floordiv": torch.floor_divide,
        "mod": torch.fmod,
        "pow": torch.pow,
        "matmul": torch.matmul,
        "and": torch.bitwise_and,
        "or": torch.bitwise_or,
        "xor": torch.bitwise_xor,
    }
    for name, fn in binary_table.items():
        op = _binary_op(fn)
        setattr(Metric, f"__{name}__", binary(op))
        setattr(Metric, f"__r{name}__", binary(op, swap=True))

    for name, fn in {
        "eq": torch.eq,
        "ne": torch.ne,
        "lt": torch.lt,
        "le": torch.le,
        "gt": torch.gt,
        "ge": torch.ge,
    }.items():
        setattr(Metric, f"__{name}__", binary(_binary_op(fn)))

    Metric.__abs__ = unary(torch.abs)  # type: ignore[attr-defined]
    Metric.__pos__ = unary(torch.abs)  # type: ignore[attr-defined]
    Metric.__neg__ = unary(_neg)  # type: ignore[attr-defined]
    Metric.__invert__ = unary(torch.bitwise_not)  # type: ignore[attr-defined]
    Metric.__inv__ = Metric.__invert__  # type: ignore[attr-defined]

    def getitem(self: Metric, idx: Any) -> CompositionalMetric:
        return CompositionalMetric(lambda x: x[idx], self, None)

    Metric.__getitem__ = getitem  # type: ignore[attr-defined]


_install_operators()
