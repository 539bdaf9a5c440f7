"""Multi-tenant keyed state: one update advances N streams.

Counterpart of ``metrics_tpu/wrappers/multitenant.py``. A service that keeps
one metric per user, segment or model variant holds N states; a
:class:`KeyedMetric` stacks the child's states on a leading **tenant axis**
instead (``(N, ...)`` tensors) and routes one mixed event batch to every
tenant with ``update(tenant_ids, *batch)``, in one pass:

1. **per-row states** — the child's pure ``apply_update`` vmapped over the
   event-row axis (:func:`~metrics_tpu_torch.utilities.stacked.row_states`),
   each row's batch-local state delta; the child's value checks run once on
   the whole batch first, since no value can be read inside the vmap;
2. **sum leaves** — every ``"sum"`` leaf of the bundle, as ``per_row -
   default``, packed into ONE ``(R, ΣD)`` float32 matrix and added into the
   stacked state by ONE launch of the segment-scatter kernel B3
   (:func:`~metrics_tpu_torch.kernels.segment_scatter.segment_scatter_add_cuda`);
3. **extremal leaves** — each ``"max"``/``"min"`` leaf through one launch of
   kernel B4, merged where the kernel's count of rows is non-zero, so empty
   segments leave their tenants untouched.

Where the JAX package sends a mixed bundle's sums through XLA's
``segment_sum`` (``multitenant.py:606-615``), the port sends them through B3
as well: the deltas of the ported metrics are integer-valued and each batch's
per-tenant sums stay far below 2^24, so the values are the same, and B3 has
no VMEM gate on the card.

:class:`MultiTenantCollection` is the collection form: members whose
:meth:`~metrics_tpu_torch.metric.Metric._shared_update_key` and state layout
agree share one stacked bundle (:meth:`MetricCollection._group_layout`), so
``[Accuracy, macro Precision/Recall/F1]`` is two bundles, and ``compute()``
fans out per member × tenant.

Tenant ids: ``update`` raises a descriptive error on out-of-range or
negative ids (``validate_ids=True``, the default); with ``False`` — and
always on the pure ``apply_update`` path — invalid rows are dropped by the
kernels (ids are clipped against the physical ``capacity``, so an id in the
padding band ``[num_tenants, capacity)`` lands in a padding row that compute
slices off). :meth:`KeyedMetric._segment_scatter` returns the dropped count
as a device scalar; no update reads it to the host.
"""
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.kernels.segment_scatter import (
    segment_scatter_add_cuda,
    segment_scatter_max_cuda,
    segment_scatter_min_cuda,
)
from metrics_tpu_torch.metric import Metric, StateDict
from metrics_tpu_torch.utilities.data import Tensor, check_device, resolve_device
from metrics_tpu_torch.utilities.stacked import broadcast_stack, row_states, vmap_compute

__all__ = ["KeyedMetric", "MultiTenantCollection"]

#: reductions the segment router can route exactly (see :func:`_keyed_gate`)
_SEGMENT_REDUCTIONS = ("sum", "max", "min")
#: leaf dtypes B3 accumulates exactly through its float32 rows
_FUSED_SCATTER_DTYPES = (torch.float32, torch.int32, torch.bfloat16)
#: leaf dtypes B4 picks exactly through its float32 rows
_EXTREMAL_SCATTER_DTYPES = (torch.float32, torch.int32, torch.bfloat16, torch.int16, torch.int8)


def _pow2_at_least(n: int) -> int:
    """The smallest power of two >= ``n`` (>= 1) — the padded-capacity
    discipline of the elastic API (``grow``/``compact``)."""
    return 1 << max(0, int(n) - 1).bit_length()


def _keyed_gate(metric: Metric, what: str = "base_metric") -> None:
    """Raise a descriptive ``ValueError`` when ``metric`` cannot be keyed.

    Keying needs fixed-shape leaves whose reductions the segment router can
    express (``"sum"`` through B3, ``"max"``/``"min"`` through B4) in dtypes
    the kernels take exactly, and the base pure-state protocol. Unbounded
    list states, ``"cat"``/``"mean"``/custom reductions, other leaf dtypes
    (the JAX package sends those to XLA) and ``dist_sync_on_step`` all stay
    single-stream.

    Integer ``"sum"`` leaves (int32) reach B3 as float32 deltas, so a keyed
    update is exact only while each tenant's sum of one leaf element within
    one batch stays below 2^24; nothing checks that bound at run time. In
    the ported metrics a row adds at most its number of elements to a leaf
    element, so a 4096-row batch of up to 4096 elements per row stays exact.
    """
    if not isinstance(metric, Metric):
        raise ValueError(f"Expected {what} to be a metrics_tpu_torch.Metric, got {metric!r}")
    name = type(metric).__name__
    if not metric._defaults:
        raise ValueError(
            f"{what} {name} registers no states, so there is nothing to key per"
            " tenant (compositions key their children instead)."
        )
    if any(isinstance(v, list) for v in metric._defaults.values()):
        raise ValueError(
            f"{what} {name} holds unbounded list states, whose size grows every"
            " step; keyed state must be fixed-shape — use the metric's"
            " `capacity=`/`streaming=` mode, or keep per-tenant instances."
        )
    bad = {
        k: fx
        for k, fx in metric._reductions.items()
        if not (isinstance(fx, str) and fx in _SEGMENT_REDUCTIONS)
    }
    if bad:
        raise ValueError(
            f"{what} {name} has state reductions the segment router cannot route"
            f" exactly: {bad}. Keyed updates support"
            f" {list(_SEGMENT_REDUCTIONS)} leaves ('sum' via segment_sum,"
            " 'max'/'min' via masked segment extremes); 'cat'/'mean'/callable"
            " reductions stay single-stream."
        )
    dtypes = {
        k: metric._defaults[k].dtype
        for k, fx in metric._reductions.items()
        if metric._defaults[k].dtype not in (_FUSED_SCATTER_DTYPES if fx == "sum" else _EXTREMAL_SCATTER_DTYPES)
    }
    if dtypes:
        raise ValueError(
            f"{what} {name} has state dtypes the segment-scatter kernels cannot"
            f" route exactly: {dtypes}. 'sum' leaves take {list(_FUSED_SCATTER_DTYPES)},"
            f" 'max'/'min' leaves {list(_EXTREMAL_SCATTER_DTYPES)}."
        )
    if set(metric.init_state()) != set(metric._defaults):
        raise ValueError(
            f"{what} {name} overrides the pure-state protocol (its init_state keys"
            " differ from the registered states), so its state cannot be stacked"
            " generically on a tenant axis."
        )
    if metric.dist_sync_on_step:
        raise ValueError(
            f"{what} {name} uses dist_sync_on_step=True, whose on-step gather"
            " cannot run inside the keyed update; sync at compute()"
            " instead (the stacked leaves sync like any state)."
        )


class KeyedMetric(Metric):
    """Hold one metric's state for ``num_tenants`` logical streams, stacked
    on a leading tenant axis and advanced by one pass per mixed event batch.

    Args:
        base_metric: the metric to key. Its update/compute are reused through
            the pure-state calls; the instance itself is cloned, and its
            accumulated state is NOT inherited — the keyed state starts at the
            defaults, like ``num_tenants`` fresh instances. It must keep its
            states on ``device``.
        num_tenants: tenant-axis size N.
        validate_ids: ``update`` raises a descriptive ``ValueError`` on
            out-of-range/negative ids (default, one host read per update).
            ``False`` skips the check: invalid rows are dropped by the kernels
            — the only behavior of the pure ``apply_update`` path.
        capacity: physical tenant-axis size of the stacked leaves (default:
            exactly ``num_tenants``). Rows in ``[num_tenants, capacity)`` are
            padding: ids validate against ``num_tenants``, and compute slices
            the padding off.
        compute_on_step: default ``False`` — per-step per-tenant values are
            rarely wanted and cost a full compute fan-out.
        dist_sync_on_step / process_group / dist_sync_fn / device: the common
            lifecycle arguments — see :class:`~metrics_tpu_torch.Metric`.
    """

    def __init__(
        self,
        base_metric: Metric,
        num_tenants: int,
        *,
        validate_ids: bool = True,
        capacity: Optional[int] = None,
        compute_on_step: bool = False,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(compute_on_step, dist_sync_on_step, process_group, dist_sync_fn, device=device)
        _keyed_gate(base_metric)
        if base_metric.device != self.device:
            raise ValueError(
                f"base_metric {type(base_metric).__name__} keeps its states on {base_metric.device}, but the"
                f" KeyedMetric is built for {self.device}"
            )
        if int(num_tenants) < 1:
            raise ValueError(f"num_tenants must be >= 1, got {num_tenants}")
        self._child = base_metric.clone()
        self.num_tenants = int(num_tenants)
        self._capacity = int(capacity) if capacity is not None else self.num_tenants
        if self._capacity < self.num_tenants:
            raise ValueError(
                f"capacity ({self._capacity}) must be >= num_tenants ({num_tenants})"
            )
        self.validate_ids = bool(validate_ids)
        for name, stacked in broadcast_stack(dict(self._child._defaults), self._capacity).items():
            self.add_state(
                name,
                stacked,
                dist_reduce_fx=self._child._reductions[name],
                persistent=self._child._persistent[name],
            )

    @property
    def capacity(self) -> int:
        """Physical tenant-axis size of the stacked leaves (>= ``num_tenants``)."""
        return self._capacity

    # ------------------------------------------------------------------
    # tenant-id canonicalization / validation
    # ------------------------------------------------------------------

    def _canonical_ids(self, tenant_ids: Any) -> Tensor:
        ids = tenant_ids if isinstance(tenant_ids, Tensor) else torch.as_tensor(tenant_ids, device=self.device)
        check_device(self.device, ids)
        if ids.dtype.is_floating_point or ids.is_complex() or ids.dtype == torch.bool:
            raise ValueError(
                f"tenant_ids must be an integer array, got dtype {ids.dtype}"
            )
        if ids.ndim != 1:
            raise ValueError(
                f"tenant_ids must be rank-1 (one id per event row), got shape {tuple(ids.shape)}"
            )
        return ids if ids.dtype in (torch.int32, torch.int64) else ids.long()

    def _validate_ids_eager(self, ids: Tensor) -> None:
        """Id check of the stateful path, in one host read: descriptive raise."""
        if ids.numel() == 0:
            return
        bad = (ids < 0) | (ids >= self.num_tenants)
        first = torch.argmax(bad.to(torch.int32))
        count, first, value = torch.stack([bad.sum(), first, ids[first].long()]).tolist()
        if count:
            raise ValueError(
                f"tenant_ids contains {count} id(s) outside the valid range"
                f" [0, {self.num_tenants}) — first offender: index {first} ="
                f" {value}. Fix the routing, raise num_tenants, or"
                " construct with validate_ids=False to clip-and-drop invalid rows."
            )

    # ------------------------------------------------------------------
    # the segment-scatter update (pure)
    # ------------------------------------------------------------------

    def _segment_scatter(
        self, state: StateDict, ids: Tensor, args: Tuple, kwargs: Dict
    ) -> Tuple[StateDict, Tensor]:
        """Pure keyed update core: ``(new_stacked_state, invalid_count)``.

        The kernels drop ids < 0 or >= the PHYSICAL capacity; an id in the
        padding band ``[num_tenants, capacity)`` lands in a padding row, which
        compute slices off. ``invalid_count`` stays on the device.
        """
        child = self._child
        n = self._capacity
        child._validate_batch(*args, **kwargs)
        per_row = row_states(child, args, kwargs)
        new: StateDict = {}
        sums = [name for name, fx in child._reductions.items() if fx == "sum"]
        if sums:
            layout, columns = [], []
            for name in sums:
                delta = per_row[name] - child._defaults[name]
                flat = delta.reshape(delta.shape[0], -1).to(torch.float32)
                layout.append((name, tuple(delta.shape[1:]), flat.shape[1]))
                columns.append(flat)
            packed, _ = segment_scatter_add_cuda(torch.cat(columns, dim=1).contiguous(), ids, n, device=self.device)
            offset = 0
            for name, shape, width in layout:
                delta = packed[:, offset:offset + width].reshape((n,) + shape)
                new[name] = state[name] + delta.to(state[name].dtype)
                offset += width
        for name, fx in child._reductions.items():
            if fx == "sum":
                continue
            rows = per_row[name]
            kernel, pick = (segment_scatter_max_cuda, torch.maximum) if fx == "max" else (segment_scatter_min_cuda,
                                                                                           torch.minimum)
            flat = rows.reshape(rows.shape[0], -1).to(torch.float32).contiguous()
            seg, counts = kernel(flat, ids, n, device=self.device)
            seg = seg.reshape((n,) + tuple(rows.shape[1:]))
            has_rows = (counts > 0).reshape((n,) + (1,) * (rows.ndim - 1))
            new[name] = torch.where(has_rows, pick(state[name], seg.to(state[name].dtype)), state[name])
        invalid = torch.sum((ids < 0) | (ids >= n)).to(torch.int32)
        return {name: new[name] for name in child._reductions}, invalid

    # ------------------------------------------------------------------
    # pure and stateful API
    # ------------------------------------------------------------------

    def apply_update(self, state: StateDict, tenant_ids: Any, *args: Any, **kwargs: Any) -> StateDict:
        """Pure keyed update: the stacked state advanced by one mixed event
        batch; invalid ids are dropped (this path never raises on them)."""
        return self._segment_scatter(state, self._canonical_ids(tenant_ids), args, kwargs)[0]

    def update(self, tenant_ids: Any, *args: Any, **kwargs: Any) -> None:
        """Route one mixed event batch to every tenant.

        ``tenant_ids`` is a rank-1 integer tensor aligned with the leading
        event-row axis of every tensor argument. With ``validate_ids=True``
        (default) out-of-range ids raise here, before anything is scattered;
        with ``False`` the kernels drop them.
        """
        ids = self._canonical_ids(tenant_ids)
        if self.validate_ids:
            self._validate_ids_eager(ids)
        new_state, _ = self._segment_scatter(self._get_states(), ids, args, kwargs)
        self._set_states(new_state)

    # ------------------------------------------------------------------
    # compute fan-out + rollups
    # ------------------------------------------------------------------

    def _visible_state(self, state: StateDict) -> StateDict:
        """The logical-tenant view of a stacked state: the ``[:num_tenants]``
        prefix when the physical capacity carries padding rows."""
        if self._capacity == self.num_tenants:
            return state
        return {k: v[: self.num_tenants] for k, v in state.items()}

    def _restore_derived(self, state: StateDict) -> None:
        self._child._restore_derived(state)

    def compute(self) -> Any:
        """Per-tenant values: the child's compute fanned out over the tenant
        axis of the (synced) stacked state. Tenants that never received a row
        compute on the default state — typically NaN for ratio metrics.
        Padding rows past ``num_tenants`` are sliced off."""
        state = self._visible_state(self._get_states())
        self._child._restore_derived(state)
        return vmap_compute(self._child)(state)

    def _scalar_values(self, key: Optional[str] = None) -> Tensor:
        vals = self.compute()
        if isinstance(vals, dict):
            if key is None:
                raise ValueError(
                    f"{type(self._child).__name__}.compute returns a dict; pass"
                    f" key=<one of {sorted(vals)}> to select the rollup series."
                )
            vals = vals[key]
        return _rollup_series(vals, "this child")

    def compute_topk(
        self, k: int, *, largest: bool = True, key: Optional[str] = None
    ) -> Tuple[Tensor, Tensor]:
        """``(values, tenant_ids)`` of the ``k`` extreme tenants by computed
        value — one ``torch.topk`` over the tenant axis. ``largest=False``
        selects the bottom-k. NaN values (never-updated tenants) sort
        unpredictably; reset or filter them first when segments may be empty."""
        if not 1 <= int(k) <= self.num_tenants:
            raise ValueError(f"k must be in [1, {self.num_tenants}], got {k}")
        return torch.topk(self._scalar_values(key), int(k), largest=largest)

    def compute_percentiles(self, q: Any, *, key: Optional[str] = None) -> Tensor:
        """Percentile(s) ``q`` (in [0, 100]) of the per-tenant values over the
        tenant axis, NaN-skipping so never-updated tenants don't poison the
        distribution."""
        return _nanpercentile(self._scalar_values(key), q)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def reset(self, tenant_ids: Optional[Any] = None) -> None:
        """Restore every tenant — or only ``tenant_ids`` — to the defaults.

        The partial form writes the child defaults into the named rows of
        every stacked leaf (out of place), leaving all other tenants'
        accumulation intact; its ids always validate."""
        if tenant_ids is None:
            return super().reset()
        ids = self._canonical_ids(tenant_ids)
        self._validate_ids_eager(ids)
        new: StateDict = {}
        for name, default in self._child._defaults.items():
            leaf = getattr(self, name).clone()
            leaf[ids] = default
            new[name] = leaf
        self._set_states(new)
        self._computed = None
        self._forward_cache = None

    def __repr__(self) -> str:
        return f"KeyedMetric({self._child!r}, num_tenants={self.num_tenants})"


def _rollup_series(vals: Any, what: str) -> Tensor:
    vals = torch.as_tensor(vals)
    if vals.ndim != 1:
        raise ValueError(
            f"rollups need one scalar per tenant; {what} computes"
            f" per-tenant values of shape {tuple(vals.shape[1:])}"
        )
    return vals


def _nanpercentile(vals: Tensor, q: Any) -> Tensor:
    vals = vals.to(torch.float32) if not vals.is_floating_point() else vals
    return torch.nanquantile(vals, torch.as_tensor(q, dtype=vals.dtype, device=vals.device) / 100)


class MultiTenantCollection:
    """A whole :class:`~metrics_tpu_torch.collections.MetricCollection` keyed
    by tenant: one stacked state bundle per layout entry, all bundles
    advanced by one ``update`` per event batch.

    Members whose shared-update key and state layout agree collapse onto one
    stacked bundle (``MetricCollection._group_layout``): macro
    ``[Precision, Recall, F1]`` over 10,000 tenants is ONE keyed update on
    ONE ``(10000, ...)`` bundle. ``compute()`` fans out
    ``{member: per-tenant values}``; :meth:`compute_topk` /
    :meth:`compute_percentiles` roll up any member's series. Member states
    start at the defaults — accumulated state of the wrapped collection is
    not inherited. Every member must keep its states on ``device``.
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric], MetricCollection],
        num_tenants: int,
        *,
        validate_ids: bool = True,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        capacity: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        if isinstance(metrics, MetricCollection):
            self._collection = metrics.clone(prefix=prefix, postfix=postfix)
        else:
            self._collection = MetricCollection(metrics, prefix=prefix, postfix=postfix)
        for name, m in self._collection.items(keep_base=True):
            _keyed_gate(m, what=f"member {name!r}")
        if int(num_tenants) < 1:
            raise ValueError(f"num_tenants must be >= 1, got {num_tenants}")
        self.num_tenants = int(num_tenants)
        self._capacity = int(capacity) if capacity is not None else self.num_tenants
        if self._capacity < self.num_tenants:
            raise ValueError(
                f"capacity ({self._capacity}) must be >= num_tenants ({num_tenants})"
            )
        self.validate_ids = bool(validate_ids)
        self.device = resolve_device(device)
        self._keyed: Optional["OrderedDict[str, KeyedMetric]"] = None
        self._layout: List[Tuple[str, list]] = []

    # ------------------------------------------------------------------
    # build: layout -> stacked bundles
    # ------------------------------------------------------------------

    def build(self, *sample_batch: Any, **kwargs: Any) -> Dict[str, list]:
        """Group the members (equal shared-update key and state layout) and
        allocate one stacked state bundle per layout entry. Called at the
        first ``update``; idempotent afterwards. The grouping reads no batch,
        so ``sample_batch`` is optional. Returns ``{owner: [member names]}``
        for the multi-member groups formed."""
        if self._keyed is None:
            coll = self._collection
            self._layout = coll._group_layout()
            self._keyed = OrderedDict(
                (owner, KeyedMetric(coll[owner], self.num_tenants, validate_ids=False, capacity=self._capacity,
                                    device=self.device))
                for owner, _ in self._layout
            )
        return {o: list(ns) for o, ns in self._layout if len(ns) > 1}

    def _require_built(self) -> "OrderedDict[str, KeyedMetric]":
        if self._keyed is None:
            raise RuntimeError(
                "MultiTenantCollection has no state bundles yet: call build("
                "*sample_batch) — or run one update — first."
            )
        return self._keyed

    @property
    def state_bundles(self) -> int:
        """Stacked state bundles one update advances (groups + singletons)."""
        return len(self._require_built())

    @property
    def capacity(self) -> int:
        """Physical tenant-axis size shared by every state bundle."""
        return self._capacity

    # ------------------------------------------------------------------
    # one update for every bundle
    # ------------------------------------------------------------------

    def _scatter_all(self, state: Dict[str, StateDict], ids: Tensor, *args: Any, **kwargs: Any) -> Dict[str, StateDict]:
        """Every bundle advanced by one batch (each member's kwargs filtered)."""
        return {
            owner: keyed._segment_scatter(state[owner], ids, args, self._collection[owner]._filter_kwargs(**kwargs))[0]
            for owner, keyed in self._keyed.items()
        }

    def _canonical_ids(self, tenant_ids: Any) -> Tensor:
        return next(iter(self._require_built().values()))._canonical_ids(tenant_ids)

    def update(self, tenant_ids: Any, *args: Any, **kwargs: Any) -> None:
        """Advance EVERY member's stacked state with one mixed event batch:
        grouped members share a bundle, so the keyed updates per batch number
        the bundles, not the members. Ids validate once, up front."""
        if self._keyed is None:
            self.build()
        keyed = self._keyed
        self._collection._check_input_device(args, kwargs)
        ids = self._canonical_ids(tenant_ids)
        if self.validate_ids:
            next(iter(keyed.values()))._validate_ids_eager(ids)
        state = {owner: km._get_states() for owner, km in keyed.items()}
        new_state = self._scatter_all(state, ids, *args, **kwargs)
        for owner, km in keyed.items():
            km._set_states(new_state[owner])
            km._update_called = True
            km._computed = None

    # ------------------------------------------------------------------
    # compute fan-out + rollups
    # ------------------------------------------------------------------

    def _member_values(self, name: str, state: StateDict) -> Any:
        member = self._collection[name]
        member._restore_derived(state)
        return vmap_compute(member)(state)

    def compute(self) -> Dict[str, Any]:
        """``{member name: per-tenant values}`` — each bundle syncs once
        (cross-process gather of the stacked leaves) and fans out to every
        member's own compute, vmapped over the tenant axis."""
        out: Dict[str, Any] = {}
        keyed = self._require_built()
        for owner, names in self._layout:
            km = keyed[owner]
            with km.sync_context(dist_sync_fn=km.dist_sync_fn):
                state = km._visible_state(km._get_states())
                for n in names:
                    out[self._collection._set_name(n)] = self._member_values(n, state)
        return out

    def _member_series(self, metric: Optional[str], key: Optional[str]) -> Tensor:
        keyed = self._require_built()
        if metric is None:
            if len(self._collection) == 1:
                metric = next(iter(self._collection.keys(keep_base=True)))
            else:
                raise ValueError(
                    "pass metric=<member name> to pick the rollup series; members:"
                    f" {list(self._collection.keys(keep_base=True))}"
                )
        if metric not in self._collection:
            raise KeyError(
                f"no member {metric!r}; members:"
                f" {list(self._collection.keys(keep_base=True))}"
            )
        owner = next(o for o, ns in self._layout if metric in ns)
        km = keyed[owner]
        with km.sync_context(dist_sync_fn=km.dist_sync_fn):
            vals = self._member_values(metric, km._visible_state(km._get_states()))
        if isinstance(vals, dict):
            if key is None:
                raise ValueError(
                    f"{metric!r} computes a dict; pass key=<one of {sorted(vals)}>."
                )
            vals = vals[key]
        return _rollup_series(vals, repr(metric))

    def compute_topk(
        self,
        k: int,
        *,
        metric: Optional[str] = None,
        largest: bool = True,
        key: Optional[str] = None,
    ) -> Tuple[Tensor, Tensor]:
        """``(values, tenant_ids)`` of the ``k`` extreme tenants by one
        member's computed value (see :meth:`KeyedMetric.compute_topk`)."""
        if not 1 <= int(k) <= self.num_tenants:
            raise ValueError(f"k must be in [1, {self.num_tenants}], got {k}")
        return torch.topk(self._member_series(metric, key), int(k), largest=largest)

    def compute_percentiles(
        self, q: Any, *, metric: Optional[str] = None, key: Optional[str] = None
    ) -> Tensor:
        """NaN-skipping percentile(s) of one member's per-tenant values (see
        :meth:`KeyedMetric.compute_percentiles`)."""
        return _nanpercentile(self._member_series(metric, key), q)

    def reset(self, tenant_ids: Optional[Any] = None) -> None:
        """Reset every bundle — all tenants, or only ``tenant_ids``."""
        if self._keyed is None:
            return
        for km in self._keyed.values():
            km.reset(tenant_ids)

    # ------------------------------------------------------------------
    # container / misc protocol
    # ------------------------------------------------------------------

    def keys(self, keep_base: bool = False) -> Any:
        return self._collection.keys(keep_base=keep_base)

    def __getitem__(self, key: str) -> Metric:
        return self._collection[key]

    def __len__(self) -> int:
        return len(self._collection)

    def __repr__(self) -> str:
        return (
            f"MultiTenantCollection({self._collection!r}, num_tenants={self.num_tenants})"
        )
