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
from copy import deepcopy
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from metrics_tpu_torch.metric import Metric, _observed_forward
from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.observability.tracing import TRACER
from metrics_tpu_torch.utilities import distributed as _dist
from metrics_tpu_torch.utilities.prints import rank_zero_warn


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

    def __getstate__(self) -> dict:
        # a clone or an unpickled copy registers a key of its own
        return {k: v for k, v in self.__dict__.items() if k != "_telemetry_key"}

    def _check_input_device(self, args: Tuple, kwargs: Dict) -> None:
        for m in self._metrics.values():
            m._check_input_device(args, kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Call forward on every metric; positional args broadcast, kwargs are
        filtered per metric signature. Shared-update classes (see
        :meth:`_shared_deltas`) run their partial-statistics pass once."""
        self._check_input_device(args, kwargs)
        shared = self._shared_deltas(args, kwargs)
        out = {}
        for name, m in self.items(keep_base=True):
            deltas = shared.get(name)
            if deltas is not None and m._states_mergeable():
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
        self._check_input_device(args, kwargs)
        shared = self._shared_deltas(args, kwargs)
        for name, m in self.items(keep_base=True):
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

    def _shared_deltas(self, args: Tuple, kwargs: Dict) -> Dict[str, Any]:
        """Per-batch partial statistics computed ONCE per equivalence class.

        Metrics advertising the same :meth:`Metric._shared_update_key` (e.g.
        Precision/Recall/F1 with identical stat-scores settings) get one
        canonicalization + one tp/fp/tn/fn pass instead of one each."""
        deltas: Dict[str, Any] = {}
        for names in self._class_groups().values():
            if len(names) < 2:
                continue
            rep = self._metrics[names[0]]
            value = rep._batch_deltas(*args, **rep._filter_kwargs(**kwargs))
            for name in names:
                deltas[name] = value
        return deltas

    def _group_layout(self) -> list:
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

    def _note_compute_groups(self) -> None:
        """Record the shared-state groups of :meth:`_group_layout` as the JAX
        package's ``build_compute_groups`` records its groups
        (``collections.py:175-190``): a ``compute_group_count`` counter, the
        ``compute_groups`` info blob and a ``compile`` event. Like it,
        records nothing for a collection of fewer than two members."""
        if len(self._metrics) < 2:
            return
        groups = {owner: list(names) for owner, names in self._group_layout() if len(names) > 1}
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
        for _, m in self.items(keep_base=True):
            m.reset()

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

    def load_state_dict(self, state_dict: dict, prefix: str = "") -> None:
        for name, m in self.items(keep_base=True):
            m.load_state_dict(state_dict, prefix=f"{prefix}{name}.")

    def add_metrics(
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
        self._metrics[key] = value

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
