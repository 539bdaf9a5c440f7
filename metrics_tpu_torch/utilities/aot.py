"""Compiled stateful dispatch: the CUDA-graph cache behind ``jit_forward``.

Counterpart of ``metrics_tpu/utilities/aot.py``. The JAX package keeps an
aval-keyed cache of AOT-compiled XLA executables that donate the state; the
port keeps, per signature, one ``torch.cuda.CUDAGraph`` of the pure program:

* **Capture.** At the first call of a signature on the card the program runs
  once on a clone of the state on a side stream (the warm-up a capture
  needs; the live state does not change), then is captured with
  ``capture_error_mode="thread_local"``, so CUDA work that other threads
  issue meanwhile (the serving flusher, the staging lane, the async engine)
  neither fails nor joins the capture. The cycle collector is paused for
  the capture: an owner and its dispatches hold each other, so a dropped
  owner's graphs are freed by the collector, and destroying a graph while
  this thread captures invalidates the capture. The graphs of one owner share one
  memory pool (:class:`GraphPool`). A capture that fails raises: nothing
  runs the step uncaptured instead.
* **Donation is writing in place.** With ``donate_state=True`` the graph's
  state inputs are the owner's own state tensors and the program's last
  step ``copy_``s the new state into them, so every replay updates the state
  where it lies. When the owner's state tensors were replaced since the
  capture (``reset()``, ``load_state_dict``) the new values are copied into
  the graph's tensors before the replay and the owner gets those back; when
  something outside the owner still holds a graph's tensors (a kept handle,
  a view) that graph is captured anew instead, so the holder keeps its
  values. ``donate_state=False`` captures over private copies and returns
  fresh tensors: the owner's state tensors are never written.
* **Replay.** The traced arguments are ``copy_``'d into the graph's input
  buffers, the graph replays, and the returned values are clones of its
  output buffers (a caller that keeps every step's value must not see it
  overwritten by the next replay).

On the CPU there is no graph: every call runs the same program under the
same trace scope (:class:`~metrics_tpu_torch.utilities.data.trace_scope`)
and writes the new state in place just as the graph does, and the cache
and its accounting (``last_compiled``, ``last_compile_s``, ``cache_info``)
are kept exactly as on the card.

**The health guard** (``observability/health.py``). With a health policy
armed, the program's guards compute their flags on the device and hand the
tensors to the dispatch instead of reading them; the program's last step
packs them into one flat tensor, a graph buffer of the capture, and each
replay queues one asynchronous copy of it to the host
(:meth:`~metrics_tpu_torch.observability.health.HealthMonitor.defer`), then
notes every earlier copy that has completed. Whether the policy is
armed is part of the key, so arming it captures afresh and disarming it
replays the graphs captured without the guard.

The key mirrors the JAX package's: python ``bool``/``str`` leaves are static
(part of the key, seen by the program as they are), tensors are traced, and
python numbers become 0-d tensors filled on every call (never baked into a
graph). The state's and the arguments' shapes, dtypes and devices are part
of the key, and ``context_fn`` (the collection's group signature) too.
"""
import gc
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from metrics_tpu_torch.kernels._common import capture_tally, note_replay
from metrics_tpu_torch.observability.health import HEALTH, FlagSlot, collect_guard_flags, pack_guard_flags
from metrics_tpu_torch.utilities.data import trace_scope

__all__ = ["CompiledDispatch", "GraphPool"]

#: leaf-layout markers: traced (device data) vs static (seen as it is)
_TRACED = 0
_STATIC = 1
#: traced leaf kinds: a tensor, or a python number carried in a 0-d tensor
_TENSOR = "tensor"
_NUMBER = "number"


class GraphPool:
    """One CUDA-graph memory pool shared by every graph of one owner (made
    at the first capture; never pickled)."""

    __slots__ = ("_handle",)

    def __init__(self) -> None:
        self._handle = None

    def handle(self) -> Any:
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


def _storage_users(t: torch.Tensor) -> int:
    """How many tensors (and storage handles) hold ``t``'s storage, the
    query's own handle not counted."""
    return torch._C._storage_Use_Count(t.untyped_storage()._cdata) - 1


class _Entry:
    """One signature's compiled program: on the card its graph, state and
    argument buffers, output buffers and launch tally; on the CPU a marker."""

    __slots__ = ("graph", "state", "args", "out_state", "in_place", "extra", "tally", "slots", "flags")

    def __init__(self) -> None:
        self.graph = None
        self.state: List[torch.Tensor] = []
        self.args: List[torch.Tensor] = []
        self.out_state: List[torch.Tensor] = []
        self.in_place: List[bool] = []
        self.extra: Any = None
        self.tally: Dict[str, int] = {}
        #: the health guards' slots in the captured program's packed flags
        self.slots: List[FlagSlot] = []
        self.flags: Optional[torch.Tensor] = None


class CompiledDispatch:
    """Signature-keyed cache of captured programs for one stateful program.

    ``fn(state, *args, **kwargs)`` is the pure program and returns
    ``(new_state, extra)``; ``__call__`` runs it and returns the same pair,
    where ``new_state`` holds the owner's own tensors, written in place
    (donation), wherever a leaf kept its shape and dtype, and ``extra`` is a
    fresh copy. Not thread-safe (the owner serializes its calls).
    """

    def __init__(
        self,
        fn: Callable,
        donate_state: bool = True,
        context_fn: Optional[Callable[[], Any]] = None,
        pool: Optional[GraphPool] = None,
        owner_refs: Optional[Callable[[torch.Tensor], int]] = None,
    ) -> None:
        self._fn = fn
        self.donate_state = bool(donate_state)
        self._context_fn = context_fn
        self._pool = pool if pool is not None else GraphPool()
        #: references to a tensor held by every compiled dispatch of the owner
        #: (its graphs share its state tensors); default: this one's alone
        self._owner_refs = owner_refs if owner_refs is not None else self.refs
        self._cache: Dict[Any, _Entry] = {}
        #: ``{id(tensor): references}`` the entries hold (their state inputs
        #: and in-place outputs); the ids stay valid while the entries hold them
        self._held: Dict[int, int] = {}
        #: True when the most recent warm()/__call__ captured (compiled) afresh
        self.last_compiled = False
        #: wall seconds of that capture, its warm-up run included (0.0 on a hit)
        self.last_compile_s = 0.0
        self._hits = 0
        self._misses = 0

    # -- argument canonicalization ------------------------------------------

    @staticmethod
    def _split(args: Tuple, kwargs: Dict, device: torch.device) -> Tuple[Any, Tuple, List, Tuple]:
        """Flatten ``(args, kwargs)`` and partition the leaves into traced
        (tensors, numpy arrays made tensors on ``device``, python numbers)
        and static (bools, strings and every other host object)."""
        leaves, treedef = tree_flatten((args, kwargs))
        layout: List[int] = []
        traced: List[Any] = []
        static: List[Any] = []
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                layout.append(_TRACED)
                traced.append(leaf)
            elif isinstance(leaf, (np.ndarray, np.generic)):
                layout.append(_TRACED)
                traced.append(torch.as_tensor(leaf, device=device))
            elif isinstance(leaf, (bool, str)):
                # bool before int (bool is an int subclass): flags steer
                # host-side branches of update()
                layout.append(_STATIC)
                static.append(leaf)
            elif isinstance(leaf, (int, float, complex)):
                layout.append(_TRACED)
                traced.append(leaf)
            else:
                layout.append(_STATIC)
                static.append(leaf)
        return treedef, tuple(layout), traced, tuple(static)

    @staticmethod
    def _sig(leaf: Any) -> Tuple:
        if isinstance(leaf, torch.Tensor):
            return (_TENSOR, tuple(leaf.shape), leaf.dtype, leaf.device)
        return (_NUMBER, type(leaf).__name__)

    def _key(self, state_leaves: List, state_def: Any, treedef: Any, layout: Tuple, traced: List,
             static: Tuple) -> Tuple:
        try:
            hash(static)
            static_key: Tuple = static
        except TypeError:  # an unhashable static leaf: its repr stands in
            static_key = tuple(repr(s) for s in static)
        return (
            self._context_fn() if self._context_fn is not None else None,
            HEALTH.enabled,
            state_def,
            tuple(self._sig(leaf) for leaf in state_leaves),
            treedef,
            layout,
            static_key,
            tuple(self._sig(leaf) for leaf in traced),
        )

    @staticmethod
    def _merge(treedef: Any, layout: Tuple, traced: List, static: Tuple) -> Tuple[Tuple, Dict]:
        merged: List[Any] = []
        t, s = iter(traced), iter(static)
        for kind in layout:
            merged.append(next(t) if kind == _TRACED else next(s))
        return tree_unflatten(merged, treedef)

    # -- the program ----------------------------------------------------------

    def _program(self, state_def: Any, state_leaves: List, treedef: Any, layout: Tuple, traced: List,
                 static: Tuple) -> Tuple[List, List[bool], Any]:
        """Run ``fn`` on ``state_leaves`` and, donating, ``copy_`` each new
        leaf of unchanged shape and dtype into its state leaf: ``(new
        leaves, written in place, extra)``."""
        args, kwargs = self._merge(treedef, layout, traced, static)
        new_state, extra = self._fn(tree_unflatten(list(state_leaves), state_def), *args, **kwargs)
        new_leaves, new_def = tree_flatten(new_state)
        if new_def != state_def:
            raise RuntimeError(f"a compiled program changed the structure of its state: {state_def} -> {new_def}")
        out, in_place = [], []
        for old, new in zip(state_leaves, new_leaves):
            keep = self.donate_state and new.shape == old.shape and new.dtype == old.dtype
            if keep and new is not old:
                old.copy_(new)
            out.append(old if keep else new)
            in_place.append(keep)
        return out, in_place, extra

    @staticmethod
    def _numbers_as_tensors(traced: List, device: torch.device) -> List[torch.Tensor]:
        return [t if isinstance(t, torch.Tensor) else torch.tensor(t, device=device) for t in traced]

    # -- capture and replay (card) -------------------------------------------------

    def _capture(self, state_def: Any, state_leaves: List, treedef: Any, layout: Tuple, traced: List,
                 static: Tuple, device: torch.device) -> _Entry:
        entry = _Entry()
        entry.args = [t.detach().clone() for t in self._numbers_as_tensors(traced, device)]
        entry.state = list(state_leaves) if self.donate_state else [t.detach().clone() for t in state_leaves]
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side), trace_scope(count_traces=False), collect_guard_flags():
            # the warm-up a capture needs, on a clone: the live state stays as it is
            self._program(state_def, [t.clone() for t in entry.state], treedef, layout, entry.args, static)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with capture_tally() as tally, trace_scope(count_traces=True), collect_guard_flags() as flags:
                with torch.cuda.graph(graph, pool=self._pool.handle(), capture_error_mode="thread_local"):
                    out, in_place, extra = self._program(state_def, entry.state, treedef, layout, entry.args, static)
                    entry.slots, entry.flags = pack_guard_flags(flags)
        finally:
            if collecting:
                gc.enable()
        entry.graph, entry.out_state, entry.in_place, entry.extra, entry.tally = graph, out, in_place, extra, tally
        return entry

    def refs(self, t: torch.Tensor) -> int:
        """How many references this cache's entries hold to the tensor
        object ``t`` (their state inputs and in-place outputs)."""
        return self._held.get(id(t), 0)

    def _hold(self, entry: _Entry, sign: int) -> None:
        for t in (*entry.state, *entry.out_state):
            n = self._held.get(id(t), 0) + sign
            if n:
                self._held[id(t)] = n
            else:
                del self._held[id(t)]

    def _store(self, key: Any, entry: _Entry) -> None:
        old = self._cache.pop(key, None)
        if old is not None:
            self._hold(old, -1)
        self._cache[key] = entry
        self._hold(entry, +1)

    def _held_outside(self, buf: torch.Tensor) -> bool:
        """True when something besides the owner's compiled dispatches holds
        the graph tensor ``buf`` (the object, or its storage through another
        tensor). Called with ``buf`` straight from an entry, never bound in
        the caller."""
        # references: the dispatches' entries, this frame's ``buf``, getrefcount's argument
        return sys.getrefcount(buf) > self._owner_refs(buf) + 2 or _storage_users(buf) > 1

    def _replay(self, key: Any, entry: _Entry, state_def: Any, state_leaves: List, traced: List,
                static: Tuple, treedef: Any, layout: Tuple, device: torch.device) -> Tuple[_Entry, List]:
        if self.donate_state:
            stale = [i for i, (b, t) in enumerate(zip(entry.state, state_leaves)) if b is not t]
            if stale and any(self._held_outside(entry.state[i]) for i in stale):
                # a holder outside would see the copy below: capture over the live tensors instead
                self._store(key, self._capture(state_def, state_leaves, treedef, layout, traced, static, device))
                entry = self._cache[key]
                self.last_compiled = True
            else:
                for i in stale:
                    entry.state[i].copy_(state_leaves[i])
        else:
            for b, t in zip(entry.state, state_leaves):
                b.copy_(t)
        for buf, t in zip(entry.args, traced):
            if isinstance(t, torch.Tensor):
                buf.copy_(t)
            else:
                buf.fill_(t)
        entry.graph.replay()
        note_replay(entry.tally)
        _defer_flags(entry.slots, entry.flags)
        out = [b if keep else b.clone() for b, keep in zip(entry.out_state, entry.in_place)]
        return entry, out

    # -- lookup ---------------------------------------------------------------

    def _lookup(self, state: Any, args: Tuple, kwargs: Dict, execute: bool) -> Tuple[Any, bool]:
        state_leaves, state_def = tree_flatten(state)
        device = state_leaves[0].device if state_leaves else torch.device("cpu")
        treedef, layout, traced, static = self._split(args, kwargs, device)
        key = self._key(state_leaves, state_def, treedef, layout, traced, static)
        entry = self._cache.get(key)
        fresh = entry is None
        self.last_compiled = fresh
        self.last_compile_s = 0.0
        if fresh:
            self._misses += 1
        else:
            self._hits += 1
        if device.type == "cuda":
            if fresh:
                start = time.perf_counter()
                entry = self._capture(state_def, state_leaves, treedef, layout, traced, static, device)
                self.last_compile_s = time.perf_counter() - start
                self._store(key, entry)
            if not execute:
                return None, fresh
            entry, out = self._replay(key, entry, state_def, state_leaves, traced, static, treedef, layout, device)
            return (tree_unflatten(out, state_def), _clone_tensors(entry.extra)), fresh
        traced = self._numbers_as_tensors(traced, device)
        if fresh:
            self._store(key, _Entry())
        if not execute:
            if fresh:
                # the CPU's counterpart of lowering: one run on a copy, whose
                # trace telemetry counts as the capture's does on the card
                start = time.perf_counter()
                with trace_scope(count_traces=True), collect_guard_flags():
                    self._program(state_def, [t.clone() for t in state_leaves], treedef, layout, traced, static)
                self.last_compile_s = time.perf_counter() - start
            return None, fresh
        with trace_scope(count_traces=fresh), collect_guard_flags() as flags:
            out, _, extra = self._program(state_def, state_leaves, treedef, layout, traced, static)
        _defer_flags(*pack_guard_flags(flags))
        return (tree_unflatten(out, state_def), extra), fresh

    # -- public surface -----------------------------------------------------------

    def warm(self, state: Any, *args: Any, **kwargs: Any) -> bool:
        """Capture (on the CPU: run once on a copy) the program for these
        arguments' signature without stepping the state; returns whether it
        was captured afresh (``False`` on a hit)."""
        return self._lookup(state, args, kwargs, execute=False)[1]

    def __call__(self, state: Any, *args: Any, **kwargs: Any) -> Tuple[Any, Any]:
        return self._lookup(state, args, kwargs, execute=True)[0]

    def _cache_size(self) -> int:
        """Captured-program count."""
        return len(self._cache)

    def cache_info(self) -> Dict[str, int]:
        """Lifetime dispatch accounting: ``{"entries", "hits", "misses"}``
        over every ``warm()``/``__call__`` lookup."""
        return {"entries": len(self._cache), "hits": self._hits, "misses": self._misses}

    def __deepcopy__(self, memo: Dict) -> None:
        raise TypeError("a CompiledDispatch holds CUDA graphs, which never copy; drop it first")

    def __reduce__(self) -> None:
        raise TypeError("a CompiledDispatch holds CUDA graphs, which never pickle; drop it first")


def _defer_flags(slots: List[FlagSlot], flags: Optional[torch.Tensor]) -> None:
    """Queue the packed guard flags of the program just run (or replayed)
    and note every queued copy that has completed."""
    if flags is not None:
        HEALTH.defer(slots, flags)
    HEALTH.drain()


def _clone_tensors(tree: Any) -> Any:
    leaves, spec = tree_flatten(tree)
    return tree_unflatten([x.clone() if isinstance(x, torch.Tensor) else x for x in leaves], spec)
