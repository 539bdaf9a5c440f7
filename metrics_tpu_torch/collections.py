"""MetricCollection: many metrics, one call.

Counterpart of ``metrics_tpu/collections.py``, limited to the eager path:
construction and naming (prefix/postfix), broadcast ``forward``/``update``
with per-metric kwarg filtering, dict ``compute``, ``reset``, ``clone`` and
``state_dict``. Members that advertise the same
:meth:`~metrics_tpu_torch.metric.Metric._shared_update_key` (macro
Precision, Recall and F1 with equal settings) share one canonicalization and
one count pass per batch (:meth:`MetricCollection._shared_deltas`), and
the keyed collection stacks them as one state bundle
(:meth:`MetricCollection._group_layout`).

Under ``torch.distributed`` :meth:`MetricCollection.compute` syncs every
packable member in ONE ``gather_all_pytrees`` per process group (one
descriptor round and one payload round), each shared-update class once
(``metrics_tpu/collections.py:890-1060``), inside one ``sync`` collective
span (``bucket="collection"``).

The compiled step (``collections.py:445-860``): :meth:`MetricCollection.jit_forward`,
:meth:`~MetricCollection.warmup` and :meth:`~MetricCollection.update_many`
run the whole collection as ONE program (on the card one CUDA graph per
input signature) over its compute groups: at the first compiled dispatch
the members of each entry of :meth:`_group_layout` whose states agree form
a group (:meth:`_build_compute_groups`), the group shares its owner's state
tensors and runs one update per batch, and every member still gets its own
on-step value. A member whose state is replaced out of band leaves its
group at the next dispatch (a new signature, captured once).

Telemetry: the collection registers its own key (:attr:`telemetry_key`);
its members count their own calls, and, as in the JAX package's eager
collection, nothing counts under the collection's key per batch. The JAX
package's dedup counters (``collections.py:380-433``) belong to its
compute groups; the port's counterpart is the keyed collection's shared
bundles, whose layout :meth:`_note_compute_groups` records at
``MultiTenantCollection.build`` and whose dedup its updates count.
"""
import time
from collections import OrderedDict
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.metric import (
    _COMPILED_ATTRS,
    _DISPATCH_ATTRS,
    _GROUP_UNSET,
    Metric,
    StateDict,
    _aliased_leaf,
    _microbatch_len,
    _note_compiled_dispatch,
    _observed_forward,
    _unrolled,
    _warmup_report,
)
from metrics_tpu_torch.observability.cost import program_cost
from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.histogram import observe_dispatch
from metrics_tpu_torch.observability.memory import LEDGER
from metrics_tpu_torch.observability.profiling import PROFILER
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.observability.retrace import arg_signature
from metrics_tpu_torch.utilities.aot import CompiledDispatch, GraphPool
from metrics_tpu_torch.observability.tracing import TRACER
from metrics_tpu_torch.utilities import distributed as _dist
from metrics_tpu_torch.utilities.prints import rank_zero_warn
from metrics_tpu_torch.utilities.profiling import compiled_scope, eager_span


class MetricCollection:
    """An ordered, dict-like container of metrics sharing one call pattern.

    Args:
        metrics: a single metric, a sequence of metrics (keyed by class name,
            duplicates rejected), or a dict name -> metric (inserted in sorted
            key order for determinism).
        additional_metrics: further metrics when ``metrics`` is not a dict.
        prefix: string prepended to every output key.
        postfix: string appended to every output key.
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
    ) -> None:
        self._metrics: "OrderedDict[str, Metric]" = OrderedDict()
        self.add_metrics(metrics, *additional_metrics)
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    @property
    def telemetry_key(self) -> str:
        """Per-instance telemetry key (see :attr:`Metric.telemetry_key`)."""
        key = self.__dict__.get("_telemetry_key")
        if key is None:
            key = TELEMETRY.register(self)
            self._telemetry_key = key
        return key

    #: the compiled step (:meth:`jit_forward`): off until asked for
    _jit_forward_enabled: bool = False
    _jit_forward_donate: bool = True
    _jit_forward_fn: Optional[CompiledDispatch] = None
    _jit_forward_copy_fn: Optional[CompiledDispatch] = None
    _update_many_fn: Optional[CompiledDispatch] = None
    _update_many_copy_fn: Optional[CompiledDispatch] = None
    #: ``[(owner, [members])]`` once the compiled step built its groups
    _compute_groups: Optional[List[Tuple[str, List[str]]]] = None

    def __getstate__(self) -> dict:
        # a clone or an unpickled copy registers a key of its own; captured
        # graphs never pickle nor copy, and the groups rebuild (value-checked)
        # at the copy's next compiled dispatch
        drop = ("_telemetry_key", "_compute_groups", "_layout_cache", *_COMPILED_ATTRS)
        return {k: v for k, v in self.__dict__.items() if k not in drop}

    def _check_input_device(self, args: Tuple, kwargs: Dict) -> None:
        for m in self._metrics.values():
            m._check_input_device(args, kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Call forward on every metric; positional args broadcast, kwargs are
        filtered per metric signature. Shared-update classes (see
        :meth:`_shared_deltas`) run their partial-statistics pass once."""
        self._check_input_device(args, kwargs)
        if self._jit_forward_enabled:
            return self._forward_jitted(*args, **kwargs)
        with self._keeping_groups():
            return self._forward_eager(args, kwargs)

    def _forward_eager(self, args: Tuple, kwargs: Dict) -> Dict[str, Any]:
        shared = self._shared_deltas(args, kwargs)
        out = {}
        for name, m in self.items(keep_base=True):
            deltas = shared.get(name)
            if deltas is not None and m._states_mergeable():
                with eager_span(f"{type(m).__name__}.forward"):
                    out[self._set_name(name)] = _observed_forward(
                        m,
                        "forward_fused_calls",
                        lambda m=m, d=deltas: m._forward_fused(
                            *args, _update_thunk=lambda: m._accumulate(*d), **m._filter_kwargs(**kwargs)
                        ),
                    )
            else:
                out[self._set_name(name)] = m(*args, **m._filter_kwargs(**kwargs))
        return out

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update every member with this batch: each shared-update class
        computes its deltas once (:meth:`_shared_deltas`), the other members
        update alone. The host span ``collection.update`` and its phases
        (``observability/tracing.py``) time it."""
        self._check_input_device(args, kwargs)
        request = TRACER.span("collection.update", path="eager", members=len(self._metrics))
        with request, self._keeping_groups():
            shared = self._shared_deltas(args, kwargs)
            request.note(shared_members=len(shared))
            for name, m in self.items(keep_base=True):
                with TRACER.phase("member_update"):
                    if name in shared:
                        m._update_from_deltas(*shared[name])
                    else:
                        m.update(*args, **m._filter_kwargs(**kwargs))

    def _class_groups(self) -> Dict[Tuple, list]:
        """Member names per shared-update equivalence key (insertion order)."""
        groups: Dict[Tuple, list] = {}
        for name, m in self.items(keep_base=True):
            key = m._shared_update_key()
            if key is not None:
                groups.setdefault(key, []).append(name)
        return groups

    def _shared_deltas(self, args: Tuple, kwargs: Dict, exclude: Iterable[str] = ()) -> Dict[str, Any]:
        """Per-batch partial statistics computed ONCE per equivalence class.

        Metrics advertising the same :meth:`Metric._shared_update_key` (e.g.
        Precision/Recall/F1 with identical stat-scores settings) get one
        canonicalization + one tp/fp/tn/fn pass instead of one each. Members
        in ``exclude`` (compute-group members, updated once per group) take
        no part."""
        deltas: Dict[str, Any] = {}
        exclude = set(exclude)
        for names in self._class_groups().values():
            names = [n for n in names if n not in exclude]
            if len(names) < 2:
                continue
            rep = self._metrics[names[0]]
            with TRACER.phase("shared_update"), compiled_scope(f"{type(rep).__name__}.shared_update"):
                value = rep._batch_deltas(*args, **rep._filter_kwargs(**kwargs))
            for name in names:
                deltas[name] = value
        return deltas

    def _group_layout(self) -> list:
        """Cached :meth:`_static_group_layout` (dropped when the members change)."""
        layout = self.__dict__.get("_layout_cache")
        if layout is None:
            layout = self.__dict__["_layout_cache"] = self._static_group_layout()
        return [(owner, list(names)) for owner, names in layout]

    def _static_group_layout(self) -> list:
        """``[(owner_name, [member names]), ...]`` in member order: one entry
        per group of members that can share one state, plus one singleton
        entry per other member. Members share when their shared-update keys
        are equal AND their state layouts (names, shapes, dtypes,
        reductions, device) are equal, so their states can never diverge: the
        exact key that stands in for the JAX package's trace fingerprints
        (``collections.py:193-228``). Members with a custom sync stay alone."""
        layout: list = []
        index: Dict[Tuple, int] = {}
        for name, m in self.items(keep_base=True):
            key = m._shared_update_key()
            if key is not None and m.dist_sync_fn is None and not m.dist_sync_on_step:
                states = tuple(
                    (k, "list" if isinstance(d, list) else (tuple(d.shape), str(d.dtype)), m._reductions[k])
                    for k, d in sorted(m._defaults.items())
                )
                key = (key, states, str(m.device), repr(m.process_group))
                if key in index:
                    layout[index[key]][1].append(name)
                    continue
                index[key] = len(layout)
            layout.append((name, [name]))
        return layout

    def _note_compute_groups(self, layout: Optional[list] = None) -> None:
        """Record the shared-state groups of ``layout`` (default
        :meth:`_group_layout`) as the JAX package's ``build_compute_groups``
        records its groups (``collections.py:175-190``): a
        ``compute_group_count`` counter, the ``compute_groups`` info blob and
        a ``compile`` event. Like it, records nothing for a collection of
        fewer than two members."""
        if len(self._metrics) < 2:
            return
        groups = {owner: list(names) for owner, names in (layout or self._group_layout()) if len(names) > 1}
        if TELEMETRY.enabled:
            key = self.telemetry_key
            TELEMETRY.inc(key, "compute_group_count", len(groups))
            TELEMETRY.set_info(key, "compute_groups", {"groups": groups, "members": len(self._metrics)})
        if EVENTS.enabled:
            EVENTS.record(
                "compile",
                self.telemetry_key,
                path="compute_groups",
                groups=list(groups.values()),
                members=len(self._metrics),
            )

    def compute(self) -> Dict[str, Any]:
        """Compute every metric; the whole collection syncs in one transport.

        Under ``torch.distributed`` every packable member's states (one
        bundle per shared-update class, whose members hold identical states)
        ride ONE ``gather_all_pytrees`` per process group: two rounds for
        the collection. Members with an injected ``dist_sync_fn``, an
        overridden sync or a pinned transport sync themselves. Every
        member's local states and sync flag are restored afterwards."""
        adopted: list = []
        try:
            self._adopt_packed_synced_states(adopted)
            return {k: m.compute() for k, m in self.items()}
        finally:
            for m, cache, prev_to_sync in adopted:
                m._set_states(cache)
                m._to_sync = prev_to_sync

    def compute_async(
        self,
        *,
        on_degraded: str = "retry",
        round_timeout_s: Optional[float] = None,
        max_retries: Optional[int] = None,
        backoff_s: Optional[float] = None,
    ) -> Any:
        """:meth:`compute` on the background engine (``collections.py:925``):
        the whole collection is cloned on the caller's thread and the clone's
        packed sync and compute run on the engine; the future resolves to the
        ``{name: value}`` dict :meth:`compute` at the snapshot would return.
        The policy arguments are :meth:`Metric.compute_async`'s."""
        from metrics_tpu_torch.utilities.async_sync import compute_async

        return compute_async(
            self, on_degraded=on_degraded, round_timeout_s=round_timeout_s, max_retries=max_retries,
            backoff_s=backoff_s,
        )

    # ------------------------------------------------------------------
    # compute groups of the compiled step
    # ------------------------------------------------------------------

    @staticmethod
    def _states_equal(a: Metric, b: Metric) -> bool:
        """Whether two members' current states agree (the group condition).
        Two members that never updated nor loaded a state hold the defaults
        and agree without a read; otherwise each leaf is compared on its
        device (a host read, once per build)."""
        fresh = [not m._update_called and not m.__dict__.get("_loaded_state") for m in (a, b)]
        if all(fresh):
            return True
        for name in a._defaults:
            va, vb = getattr(a, name), getattr(b, name)
            if va is vb:
                continue
            if isinstance(va, list) or isinstance(vb, list):
                return False
            if va.shape != vb.shape or va.dtype != vb.dtype or not torch.equal(va, vb):
                return False
        return True

    def _build_compute_groups(self) -> list:
        """Group, per entry of :meth:`_group_layout`, the owner with every
        member whose state agrees with its own (``collections.py:130``); the
        group's members then share the owner's state tensors. Returns the
        dispatch layout ``[(owner, [members])]``."""
        layout: list = []
        for owner, names in self._group_layout():
            o = self._metrics[owner]
            members = [owner] + [n for n in names[1:] if self._states_equal(o, self._metrics[n])]
            layout.append((owner, members))
            layout.extend((n, [n]) for n in names if n not in members)
        self.__dict__["_compute_groups"] = layout
        self._reshare_groups()
        self._note_compute_groups(layout)
        return layout

    @contextmanager
    def _keeping_groups(self) -> Iterator[None]:
        """Around an eager step or a reset of every member: the groups'
        members (those still sharing their owner's tensors when it starts)
        hold equal values after it in tensors of their own, and share the
        owner's again."""
        if self.__dict__.get("_compute_groups") is None:
            yield
            return
        self._dispatch_layout()  # a member changed out of band leaves its group first
        yield
        self._reshare_groups()

    def _reshare_groups(self) -> None:
        """Point each group's followers at the owner's state tensors."""
        for owner, names in self.__dict__.get("_compute_groups") or ():
            states = self._metrics[owner]._get_states()
            for n in names[1:]:
                self._metrics[n]._set_states(dict(states))

    def _dissolve_compute_groups(self) -> None:
        """Ungroup every member, each keeping a copy of the state it sees
        (a state tensor shared with the owner would otherwise follow the
        owner's in-place updates)."""
        for owner, names in self.__dict__.get("_compute_groups") or ():
            states = self._metrics[owner]._get_states() if owner in self._metrics else {}
            for n in names[1:]:
                m = self._metrics.get(n)
                if m is None:
                    continue
                mine = m._get_states()
                m._set_states({k: (v.clone() if v is states.get(k) else v) for k, v in mine.items()})
        self.__dict__["_compute_groups"] = None

    def _dispatch_layout(self) -> list:
        """The compute groups for this dispatch: built at the first compiled
        dispatch; a follower whose state tensors are no longer the owner's
        (replaced out of band) leaves its group (the JAX package's
        copy-on-write detach)."""
        layout = self.__dict__.get("_compute_groups")
        if layout is None:
            return self._build_compute_groups()
        fixed: list = []
        changed = False
        for owner, names in layout:
            states = self._metrics[owner]._get_states()
            keep = [owner]
            for n in names[1:]:
                mine = self._metrics[n]._get_states()
                if all(mine[k] is states[k] for k in states):
                    keep.append(n)
                else:
                    changed = True
                    fixed.append((n, [n]))
            fixed.insert(len(fixed) - (len(names) - len(keep)), (owner, keep))
        if changed:
            self.__dict__["_compute_groups"] = fixed
        return fixed if changed else layout

    def _group_signature(self) -> Tuple:
        """The dispatch layout as a key (``CompiledDispatch(context_fn=...)``):
        a detach re-keys the captured program instead of replaying a stale one."""
        return tuple((owner, tuple(names)) for owner, names in self.__dict__.get("_compute_groups") or ())

    # ------------------------------------------------------------------
    # pure-state fan-out
    # ------------------------------------------------------------------

    def init_state(self) -> Dict[str, StateDict]:
        """Fresh states for every member, keyed by base name."""
        return {name: m.init_state() for name, m in self.items(keep_base=True)}

    def apply_update(self, state: Dict[str, StateDict], *args: Any, **kwargs: Any) -> Dict[str, StateDict]:
        """Every member's state advanced by this batch in one pass; each
        shared-update class canonicalizes and counts once (``collections.py:1189``)."""
        shared = self._shared_deltas(args, kwargs)
        return {
            name: (
                m._apply_accumulate(state[name], shared[name])
                if name in shared
                else m.apply_update(state[name], *args, **m._filter_kwargs(**kwargs))
            )
            for name, m in self.items(keep_base=True)
        }

    def apply_compute(self, state: Dict[str, StateDict], process_group: Any = _GROUP_UNSET) -> Dict[str, Any]:
        """Every member's value of its state, synced over ``process_group``
        (default: each member's own; ``None``: no sync). The collection-wide
        packed sync is the stateful :meth:`compute`'s."""
        return {self._set_name(name): m.apply_compute(state[name], process_group=process_group)
                for name, m in self.items(keep_base=True)}

    def apply_forward(
        self, state: Dict[str, StateDict], *args: Any, process_group: Any = _GROUP_UNSET, **kwargs: Any
    ) -> Tuple[Dict[str, StateDict], Dict[str, Any]]:
        """``(accumulated states, per-batch values)`` with one shared update
        pass (:meth:`apply_update` on fresh states), each member merging its
        batch state as :meth:`Metric.apply_forward` does."""
        batch = self.apply_update(self.init_state(), *args, **kwargs)
        new_state: Dict[str, StateDict] = {}
        values: Dict[str, Any] = {}
        for name, m in self.items(keep_base=True):
            new_state[name], values[self._set_name(name)] = m.apply_forward(
                state[name], *args, process_group=process_group, batch_state=batch[name],
                **m._filter_kwargs(**kwargs),
            )
        return new_state, values

    def _grouped_batch(self, layout: list, args: Tuple, kwargs: Dict, state: Optional[Dict[str, StateDict]]
                       ) -> Dict[str, StateDict]:
        """One update per layout entry: of ``state`` (or of fresh states when
        ``None``), shared deltas for the ungrouped members of a class."""
        grouped = {n for _, ns in layout if len(ns) > 1 for n in ns}
        deltas = self._shared_deltas(args, kwargs, exclude=grouped)
        out: Dict[str, StateDict] = {}
        for owner, _ in layout:
            m = self._metrics[owner]
            base = m.init_state() if state is None else state[owner]
            if owner in deltas:
                out[owner] = m._apply_accumulate(base, deltas[owner])
            else:
                out[owner] = m.apply_update(base, *args, **m._filter_kwargs(**kwargs))
        return out

    def _grouped_apply_forward(self, state: Dict[str, StateDict], *args: Any, **kwargs: Any
                               ) -> Tuple[Dict[str, StateDict], Dict[str, Any]]:
        """:meth:`apply_forward` over the dispatch layout
        (``collections.py:501``): one state bundle and one update pass per
        group, keyed by its owner; every member gets its on-step value from
        the group's batch state (``None`` without ``compute_on_step``)."""
        layout = self.__dict__["_compute_groups"]
        batch = self._grouped_batch(layout, args, kwargs, None)
        new_state: Dict[str, StateDict] = {}
        values: Dict[str, Any] = {}
        for owner, names in layout:
            m = self._metrics[owner]
            new_state[owner], value = m.apply_forward(
                state[owner], *args, process_group=None, batch_state=batch[owner], **m._filter_kwargs(**kwargs)
            )
            values[self._set_name(owner)] = value if m.compute_on_step else None
            for n in names[1:]:
                mm = self._metrics[n]
                values[self._set_name(n)] = mm.apply_compute(batch[owner], process_group=None) if mm.compute_on_step else None
        return new_state, values

    def _grouped_apply_update(self, state: Dict[str, StateDict], *args: Any, **kwargs: Any) -> Dict[str, StateDict]:
        """:meth:`apply_update` over the dispatch layout (one update per group)."""
        return self._grouped_batch(self.__dict__["_compute_groups"], args, kwargs, state)

    # ------------------------------------------------------------------
    # the compiled step
    # ------------------------------------------------------------------

    def jit_forward(self, enable: bool = True, donate: bool = True) -> "MetricCollection":
        """Run the collection's stateful ``forward`` as ONE compiled program
        (``collections.py:445``), with :meth:`Metric.jit_forward`'s contract
        and trades: one CUDA graph per input signature on the card, the
        members' state tensors written in place (``donate=False`` copies; a
        member state held outside takes the step through the copying graph,
        with a one-shot warning). Shared-update classes canonicalize once
        and compute groups update once inside it. Every member must pass
        :meth:`Metric.jit_forward`'s gate; a member's own enablement stays
        as it is."""
        if not enable:
            self._jit_forward_enabled = False
            self._drop_compiled_dispatch()
            return self
        for name, m in self.items(keep_base=True):
            try:
                m._jit_forward_gate()
            except ValueError as err:
                raise ValueError(f"member {name!r}: {err}") from None
        self._jit_forward_enabled = True
        self._jit_forward_donate = bool(donate)
        self._drop_compiled_dispatch()
        return self

    def _drop_compiled_dispatch(self) -> None:
        for name in ("_jit_forward_fn", "_jit_forward_copy_fn", "_update_many_fn", "_update_many_copy_fn"):
            self.__dict__[name] = None

    def _pool(self) -> GraphPool:
        pool = self.__dict__.get("_graph_pool")
        if pool is None:
            pool = self.__dict__["_graph_pool"] = GraphPool()
        return pool

    def _dispatch_refs(self, t: Any) -> int:
        """References to ``t`` held by every compiled dispatch of this collection."""
        return sum(d.refs(t) for d in (self.__dict__.get(n) for n in _DISPATCH_ATTRS[:4]) if d is not None)

    def _dispatch(self, name: str, program: Any, donate: bool) -> CompiledDispatch:
        fn = self.__dict__.get(name)
        if fn is None:
            fn = CompiledDispatch(program, donate_state=donate, context_fn=self._group_signature, pool=self._pool(),
                                  owner_refs=self._dispatch_refs)
            self.__dict__[name] = fn
        return fn

    def _collect_dispatch_state(self) -> Dict[str, StateDict]:
        """The state bundles a compiled dispatch threads (``collections.py:566``):
        one per layout entry, keyed by its owner (the nine-member ImageNet
        collection threads five bundles). Clears every member's cached
        values first."""
        for _, m in self.items(keep_base=True):
            m._computed = None
            m._forward_cache = None
        return {owner: self._metrics[owner]._get_states() for owner, _ in self.__dict__["_compute_groups"]}

    def _writeback_dispatch_state(self, new_state: Dict[str, StateDict]) -> int:
        """Adopt a dispatch's states (followers share the owner's tensors) and
        refresh every member's step flags; returns the member updates the
        groups saved."""
        skipped = 0
        for owner, names in self.__dict__["_compute_groups"]:
            for n in names:
                m = self._metrics[n]
                m._set_states(dict(new_state[owner]))
                m._update_called = True
                m._computed = None
            skipped += len(names) - 1
        return skipped

    def _donation_safe_state(self, state: Dict[str, StateDict]) -> Tuple[Dict[str, StateDict], bool]:
        """Collection-wide :meth:`Metric._donation_safe_state`
        (``collections.py:600``): any member state held outside its members
        sends the whole step through the copying graph (one program: in
        place for all or for none)."""
        dispatches = tuple(self.__dict__.get(n) for n in _DISPATCH_ATTRS[:4])
        aliased = None
        for owner, names in self.__dict__["_compute_groups"]:
            followers = [self._metrics[n] for n in names[1:]]

            def shared(sname: str, v: Any, followers: list = followers) -> int:
                return sum(1 for f in followers if f.__dict__.get(sname) is v)

            name = _aliased_leaf(state[owner], dispatches, shared)
            if name is not None:
                aliased = f"{owner}.{name}"
                break
        if aliased is None:
            return state, True
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "jit_forward_alias_fallbacks")
        if not self.__dict__.get("_donation_warned", False):
            self._donation_warned = True
            rank_zero_warn(
                f"MetricCollection.jit_forward: member state `{aliased}` is referenced"
                " outside its metric, so this step dispatches through the copying"
                " graph instead of writing the state tensors in place. Drop external"
                " references to member states to restore in-place updates, or call"
                " jit_forward(donate=False) to keep the copying path silently.",
                UserWarning,
            )
        return state, False

    def _forward_jitted(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        self._dispatch_layout()
        state = self._collect_dispatch_state()
        donatable = False
        if self._jit_forward_donate:
            state, donatable = self._donation_safe_state(state)
        fn = self._dispatch("_jit_forward_fn" if donatable else "_jit_forward_copy_fn",
                            self._grouped_apply_forward, donatable)
        prof = PROFILER.begin("compiled", self._device())
        start = time.perf_counter() if (EVENTS.enabled or TELEMETRY.enabled) else None
        new_state, values = fn(state, *args, **kwargs)
        submitted = time.perf_counter() if (start is not None or prof is not None) else None
        if prof is not None:
            PROFILER.finish(prof, self.telemetry_key, fn, submit_end=submitted)
        if start is not None:
            dur = submitted - start
            if TELEMETRY.enabled:
                observe_dispatch(dur, "compiled")
            EVENTS.record(
                "forward", self.telemetry_key, dur_s=dur, t_start=start, path="compiled",
                members=len(self._metrics), state_bundles=len(state),
                compiled_this_call=bool(fn.last_compiled), donated=fn.donate_state,
            )
        record = TELEMETRY.enabled
        if record:
            # one program serves every member: the collection's key carries
            # the compiles, each member counts its dispatch
            _note_compiled_dispatch(self, fn, args, kwargs)
        skipped = self._writeback_dispatch_state(new_state)
        if record and skipped:
            TELEMETRY.inc(self.telemetry_key, "update_dedup_skipped", skipped)
        out = {}
        for name, m in self.items(keep_base=True):
            if record:
                TELEMETRY.inc(m.telemetry_key, "forward_compiled_calls")
            m._forward_cache = out[self._set_name(name)] = values[self._set_name(name)]
        return out

    def warmup(self, *sample_batch: Any, **kwargs: Any) -> Dict[str, Any]:
        """Capture the collection's ``jit_forward`` program for this batch's
        signature ahead of the first step (``collections.py:692``; see
        :meth:`Metric.warmup`). Enables :meth:`jit_forward` if needed."""
        if not self._jit_forward_enabled:
            self.jit_forward(donate=self._jit_forward_donate)
        self._check_input_device(sample_batch, kwargs)
        self._dispatch_layout()
        state = self._collect_dispatch_state()
        fn = self._dispatch("_jit_forward_fn" if self._jit_forward_donate else "_jit_forward_copy_fn",
                            self._grouped_apply_forward, self._jit_forward_donate)
        start = time.perf_counter()
        fresh = fn.warm(state, *sample_batch, **kwargs)
        return _warmup_report(self, fn, fresh, start, arg_signature(*sample_batch, **kwargs), type(self).__name__,
                              self.state_memory_report(), members=len(self._metrics))

    def _scan_update_many(self, state: Dict[str, StateDict], stacked: Tuple, stacked_kwargs: Dict
                          ) -> Tuple[Dict[str, StateDict], None]:
        """K :meth:`_grouped_apply_update` steps unrolled into one program
        (``collections.py:738``)."""
        return _unrolled(self._grouped_apply_update, state, stacked, stacked_kwargs), None

    def update_many(self, *stacked: Any, **stacked_kwargs: Any) -> None:
        """Accumulate K stacked micro-batches across every member in ONE
        compiled dispatch (``collections.py:765``; see
        :meth:`Metric.update_many`); works with or without :meth:`jit_forward`."""
        for name, m in self.items(keep_base=True):
            try:
                m._compiled_state_gate()
            except ValueError as err:
                raise ValueError(f"member {name!r}: {err}") from None
        self._check_input_device(stacked, stacked_kwargs)
        k = _microbatch_len(stacked, stacked_kwargs)
        self._dispatch_layout()
        state = self._collect_dispatch_state()
        donatable = True
        if self._jit_forward_donate:
            state, donatable = self._donation_safe_state(state)
        donate = donatable and self._jit_forward_donate
        fn = self._dispatch("_update_many_fn" if donate else "_update_many_copy_fn", self._scan_update_many, donate)
        prof = PROFILER.begin("update_many", self._device())
        start = time.perf_counter() if (TELEMETRY.enabled or EVENTS.enabled) else None
        new_state, _ = fn(state, stacked, stacked_kwargs)
        submitted = time.perf_counter() if (start is not None or prof is not None) else None
        if prof is not None:
            PROFILER.finish(prof, self.telemetry_key, fn, submit_end=submitted)
        if start is not None:
            dur = submitted - start
            key = self.telemetry_key
            if TELEMETRY.enabled:
                TELEMETRY.inc(key, "update_many_calls")
                TELEMETRY.inc(key, "update_many_batches", k)
                observe_dispatch(dur, "update_many")
                _note_compiled_dispatch(self, fn, stacked, stacked_kwargs, counter="update_many_dispatches")
            EVENTS.record(
                "update", key, dur_s=dur, t_start=start, path="scan_microbatch", batches=k,
                members=len(self._metrics), state_bundles=len(state),
                compiled_this_call=bool(fn.last_compiled), donated=fn.donate_state,
            )
        skipped = self._writeback_dispatch_state(new_state)
        if TELEMETRY.enabled and skipped:
            TELEMETRY.inc(self.telemetry_key, "update_dedup_skipped", skipped * k)

    def _class_aliases(self, *, packed: bool) -> Dict[str, List[str]]:
        """``{representative: [class members]}`` for each shared-update class
        that can sync once: equal reductions, group, gather (and, for the
        packed sync, transport), and some member without a cached value."""
        alias: Dict[str, List[str]] = {}
        for names in self._class_groups().values():
            if len(names) < 2 or all(self._metrics[n]._computed is not None for n in names):
                continue
            rep = self._metrics[names[0]]
            if any(
                self._metrics[n]._reductions != rep._reductions
                or self._metrics[n].process_group != rep.process_group
                or self._metrics[n].dist_sync_fn is not rep.dist_sync_fn
                or (packed and self._metrics[n].transport is not rep.transport)
                for n in names[1:]
            ):
                continue
            alias[names[0]] = names
        return alias

    def _fan_out(self, names: List[str], adopted: list) -> None:
        """Point the other members of a class at the representative's synced states."""
        synced = self._metrics[names[0]]._get_states()
        for n in names[1:]:
            m = self._metrics[n]
            adopted.append((m, m._get_states(), m._to_sync))
            m._set_states({k: (list(v) if isinstance(v, list) else v) for k, v in synced.items()})
            m._to_sync = False

    def _adopt_packed_synced_states(self, adopted: list) -> None:
        """Sync every packable member in ONE packed gather per process group
        and point the members at the synced states; restore records go to
        ``adopted`` as they happen, so a failure midway is fully restorable.

        Packable: the default gather (no ``dist_sync_fn``), the base
        ``Metric._sync_dist``, no pinned transport, at least one state, sync
        not already off. A shared-update class sends its representative's
        bundle once; the rest syncs per class or per member."""
        if not _dist.distributed_available():
            return self._adopt_class_synced_states(adopted)
        alias = self._class_aliases(packed=True)
        aliased = {n for names in alias.values() for n in names[1:]}
        bundles: Dict[str, Tuple[Any, List[str]]] = {}
        for name, m in self.items(keep_base=True):
            if name in aliased or (m._computed is not None and name not in alias):
                continue
            if (
                m.dist_sync_fn is not None
                or type(m)._sync_dist is not Metric._sync_dist
                or m.transport is not None
                or not m._defaults
                or not m._to_sync
            ):
                continue
            bundles.setdefault(repr(m.process_group), (m.process_group, []))[1].append(name)

        for group, names in bundles.values():
            pre = [self._metrics[n]._pre_sync_states() for n in names]
            sync_start = time.perf_counter() if EVENTS.enabled else None
            # one span around the whole bundle: a deterministic id per epoch
            # sync, shared by every participating process
            span = (
                TRACER.begin("sync", group=_dist.group_label(group), bucket="collection") if TRACER.enabled else None
            )
            gathered = _dist.gather_all_pytrees([states for states, _ in pre], group=group)
            span_id = TRACER.end(span, collection=self.telemetry_key, members=list(names)) if span else None
            if sync_start is not None:
                EVENTS.record(
                    "sync",
                    self.telemetry_key,
                    dur_s=time.perf_counter() - sync_start,
                    t_start=sync_start,
                    members=list(names),
                    packed=True,
                    span_id=span_id,
                )
            for n, (states, list_dtypes), g in zip(names, pre, gathered):
                m = self._metrics[n]
                m._note_sync_telemetry(states)
                adopted.append((m, m._get_states(), m._to_sync))
                m._apply_gathered_states(g, list_dtypes)
                m._to_sync = False  # synced: compute() must not gather again
                if n in alias:
                    self._fan_out(alias[n], adopted)
        self._adopt_class_synced_states(adopted, skip={n for _, ns in bundles.values() for n in ns} | aliased)

    def _adopt_class_synced_states(self, adopted: list, skip: Optional[set] = None) -> None:
        """Sync one representative per shared-update class and point the
        members at its synced states (a no-op when nothing syncs). ``skip``
        names members the packed sync already served."""
        for names in self._class_aliases(packed=False).values():
            if skip and any(n in skip for n in names):
                continue
            rep = self._metrics[names[0]]
            cache = rep.sync(dist_sync_fn=rep.dist_sync_fn, process_group=rep.process_group)
            if not cache:
                continue
            adopted.append((rep, cache, rep._to_sync))
            rep._to_sync = False
            self._fan_out(names, adopted)

    def reset(self) -> None:
        with self._keeping_groups():
            for _, m in self.items(keep_base=True):
                m.reset()

    def keyed(self, num_tenants: int, **kwargs: Any) -> Any:
        """An N-tenant stacked view of this collection (``collections.py:1148``):
        a :class:`~metrics_tpu_torch.wrappers.multitenant.MultiTenantCollection`
        holding one stacked state bundle per compute-group layout entry, all
        advanced by one update per batch, on the members' device unless
        ``device=`` says otherwise. State starts at the defaults."""
        from metrics_tpu_torch.wrappers.multitenant import MultiTenantCollection

        first = next(iter(self.values()), None)
        if first is not None:
            kwargs.setdefault("device", first.device)
        return MultiTenantCollection(self, num_tenants, **kwargs)

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for _, m in self.items(keep_base=True):
            m.persistent(mode)

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        destination = {} if destination is None else destination
        for name, m in self.items(keep_base=True):
            m.state_dict(destination, prefix=f"{prefix}{name}.")
        return destination

    # ------------------------------------------------------------------
    # observability reports
    # ------------------------------------------------------------------

    def _device(self) -> torch.device:
        """Where the members' states live (the first member's device)."""
        return next(iter(self._metrics.values())).device

    def check_health(self, state: Optional[Dict[str, StateDict]] = None) -> Dict[str, Any]:
        """Every member's :meth:`Metric.check_health`, keyed by base name,
        plus their conjunction (``collections.py:1428``)."""
        state = state or {}
        members = {name: m.check_health(state.get(name)) for name, m in self.items(keep_base=True)}
        return {"healthy": all(r["healthy"] for r in members.values()), "members": members}

    def state_memory_report(self) -> Dict[str, Any]:
        """Every member's :meth:`Metric.state_memory_report`
        (``collections.py:1441``); members of a group share one bundle and
        each reports it."""
        per_metric = {name: m.state_memory_report() for name, m in self.items(keep_base=True)}
        return {"per_metric": per_metric, "total_bytes": int(sum(r["total_bytes"] for r in per_metric.values()))}

    def cost_report(self, *example_batch: Any, **kwargs: Any) -> Dict[str, Any]:
        """The JAX package's keys (``collections.py:1450``): the fused
        update's and each member's cost entries are unavailable without an
        XLA cost analysis; ``state_memory`` is :meth:`state_memory_report`."""
        return {
            "fused_update": program_cost(self.apply_update, self.init_state(), *example_batch, **kwargs),
            "members": {name: m.cost_report(*example_batch, **m._filter_kwargs(**kwargs))
                        for name, m in self.items(keep_base=True)},
            "state_memory": self.state_memory_report(),
        }

    def load_state_dict(self, state_dict: dict, prefix: str = "") -> None:
        # loaded states may disagree within a group: regroup (value-checked)
        # at the next compiled dispatch
        self._dissolve_compute_groups()
        for name, m in self.items(keep_base=True):
            m.load_state_dict(state_dict, prefix=f"{prefix}{name}.")

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Add members. With the compiled step enabled every new member must
        pass its gate, or none is added (``ValueError``); a grown collection
        drops its captured programs and groups, which rebuild at the next
        compiled dispatch (``collections.py:1476``)."""
        before = list(self._metrics)
        self._add_metrics(metrics, *additional_metrics)
        self._members_changed()
        if self._jit_forward_enabled:
            for name in [n for n in self._metrics if n not in before]:
                try:
                    self._metrics[name]._jit_forward_gate()
                except ValueError as err:
                    for n in [n for n in self._metrics if n not in before]:
                        del self._metrics[n]
                    self._members_changed()
                    raise ValueError(f"member {name!r}: {err}") from None
        # new members mean new state bundles: re-note the memory ledger at
        # the seam that invalidated the captured programs
        LEDGER.note(self)

    def _members_changed(self) -> None:
        """The member set changed: drop the cached layout, the groups and
        every captured program."""
        self.__dict__.pop("_layout_cache", None)
        self._dissolve_compute_groups()
        self._drop_compiled_dispatch()

    def _add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, Metric):
                    raise ValueError(f"Value {metric} belonging to key {name} is not an instance of `Metric`")
                self._metrics[name] = metric
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, Metric):
                    raise ValueError(f"Input {metric} to `MetricCollection` is not a instance of `Metric`")
                name = metric.__class__.__name__
                if name in self._metrics:
                    raise ValueError(f"Encountered two metrics both named {name}")
                self._metrics[name] = metric
        else:
            raise ValueError("Unknown input to MetricCollection.")

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def _renamed(self) -> "OrderedDict[str, Metric]":
        return OrderedDict((self._set_name(k), v) for k, v in self._metrics.items())

    def keys(self, keep_base: bool = False) -> Iterable[str]:
        return self._metrics.keys() if keep_base else self._renamed().keys()

    def values(self) -> Iterable[Metric]:
        return self._metrics.values()

    def items(self, keep_base: bool = False) -> Iterable[Tuple[str, Metric]]:
        return self._metrics.items() if keep_base else self._renamed().items()

    def __getitem__(self, key: str) -> Metric:
        return self._metrics[key]

    def __setitem__(self, key: str, value: Metric) -> None:
        if not isinstance(value, Metric):
            raise ValueError(f"Value {value} is not an instance of `Metric`")
        if self._jit_forward_enabled:
            value._jit_forward_gate()
        # a replaced member leaves its group with a state of its own first
        self._dissolve_compute_groups()
        self._metrics[key] = value
        self._members_changed()

    def __contains__(self, key: str) -> bool:
        return key in self._metrics

    def __iter__(self) -> Iterable[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def __repr__(self) -> str:
        lines = [f"  ({k}): {v!r}" for k, v in self._metrics.items()]
        body = "\n".join(lines)
        out = f"{self.__class__.__name__}(\n{body}"
        if self.prefix:
            out += f",\n  prefix={self.prefix}{',' if self.postfix else ''}"
        if self.postfix:
            out += f"{',' if not self.prefix else ''}\n  postfix={self.postfix}"
        return out + "\n)"
