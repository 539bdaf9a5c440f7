"""Multi-tenant keyed state: one update advances N streams.

Counterpart of ``metrics_tpu/wrappers/multitenant.py``. A service that keeps
one metric per user, segment or model variant holds N states; a
:class:`KeyedMetric` stacks the child's states on a leading **tenant axis**
instead (``(N, ...)`` tensors) and routes one mixed event batch to every
tenant with ``update(tenant_ids, *batch)``, in one pass:

1. **per-row states** — each row's batch-local state delta
   (:func:`~metrics_tpu_torch.utilities.stacked.row_states`): the child's
   batched-rows form where it has one for the inputs (the stat-scores
   family: the batch canonicalized once, macro rows counted by one launch of
   B1's batched entry), else its pure ``apply_update`` vmapped over the
   event-row axis; the child's value checks run once on the whole batch
   first, since neither form reads a value;
2. **the merge** — every int32 and float32 leaf of the update, ``"sum"``,
   ``"max"`` or ``"min"``, of every bundle (a :class:`MultiTenantCollection`
   merges all its bundles' leaves at once), routed into its new stacked
   state by ONE launch of the merge kernel
   (:func:`~metrics_tpu_torch.kernels.segment_scatter.segment_merge_cuda`):
   a sum leaf adds ``per_row - default`` (int32 exactly at any size, by
   integer atomics; float32 as the batch's sum, then ``state + sum``), an
   extremal leaf picks against its state in XLA's order (NaN on top, +0.0
   above -0.0), and a tenant without rows keeps its state. The rows are
   read where they lie (a broadcast default, a slice of B1's batched
   output); the launch also gives the per-tenant row counts and the
   dropped-id count. Which leaves take it is fixed by their dtypes when the
   bundle's plan is built (:meth:`KeyedMetric._scatter_plan`);
3. **bfloat16 sums and small-integer extrema** — the bfloat16 ``"sum"``
   leaves as ``per_row - default`` packed into ONE ``(R, ΣD)`` float32
   matrix and added by ONE launch of B3
   (:func:`~metrics_tpu_torch.kernels.segment_scatter.segment_scatter_add_cuda`);
   each bfloat16, int16 or int8 ``"max"``/``"min"`` leaf picked by one
   launch of B4 and merged where the kernel's count of rows is non-zero, so
   empty segments leave their tenants untouched;
4. **leaves of any other dtype** (float64, int64: the regression metrics'
   moment sums and counts) — added in their own dtype by a plain
   ``index_add_`` over an ``S+1``-row buffer whose last row takes the ids
   outside ``[0, capacity)`` (one per dtype, the leaves of a dtype packed),
   or picked by a plain ``scatter_reduce_``
   (:func:`~metrics_tpu_torch.kernels.segment_scatter.segment_sum_plain`,
   :func:`~metrics_tpu_torch.kernels.segment_scatter.segment_extremal_plain`).
   This is the counterpart of the JAX package's ``segment_sum`` for such
   leaves (``multitenant.py:489-511``), chosen by the leaf's dtype alone.
   Each such scatter counts under its op's ``"plain"`` dispatch path (once
   per dispatch, and once per capture inside a compiled step).

Where the JAX package sends a mixed bundle's leaves through XLA's
``segment_sum``/``segment_max`` (``multitenant.py:606-615``), fused by XLA
into one program, the port sends its int32 and float32 leaves through the
merge: int32 sums exact as ``segment_sum`` in int32 is, extrema in XLA's
order, float32 sums to rounding.

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
(the merge's, else a sum of the ids out of range) as a device scalar; no
update reads it to the host. With telemetry on it is added into a
device-side accumulator under ``invalid_tenant_ids``
(``metrics_tpu/wrappers/multitenant.py:318-321``), read only when
``observability.snapshot()`` or ``TELEMETRY.counter`` asks, so a keyed
update makes the same synchronizing calls with telemetry on as off.

Telemetry (``multitenant.py:711-745,1135-1180,1347-1390``): each keyed
update counts its rows (``keyed_update_rows``) and its dispatch
(``keyed_update_dispatches``), observes its host time under
``dispatch_seconds{path=keyed_scatter}`` and records an ``update`` event
with ``path="keyed_scatter"``; the collection's build records its layout
(``info.keyed``, the ``compute_groups`` of its inner collection and a
``compile`` event) and each collection update the members its bundles
serve beyond one (``update_dedup_skipped``).

The compiled step (``multitenant.py:664-780,1380-1470``): after
:meth:`KeyedMetric.warmup` or :meth:`KeyedMetric.jit_forward` (and
:meth:`MultiTenantCollection.warmup`) the keyed update dispatches through a
:class:`~metrics_tpu_torch.utilities.aot.CompiledDispatch` (one CUDA graph
per batch signature on the card; the stacked state written in place), as
every JAX keyed update does; without them it stays eager. The eager id
check stays outside the graph (``validate_ids=True``), and the tenant
ledger and the invalid-id counter are fed the graph's outputs after the
replay. ``update_many`` runs K stacked cohorts as K keyed updates unrolled
into one graph. The compiled counters (``jit_forward_compiles``,
``update_many_*``, ``warmup_*``, ``update_traces``) count as in the JAX
package.

Serving (``multitenant.py:156-314,433-441,679-720``): ``update`` runs under a
lazy, process-local re-entrant lock (:meth:`KeyedMetric._serial_lock`,
dropped on pickle and clone), so the admission queue's flusher and other
ingest threads never interleave their read-modify-write of the stacked
state. While telemetry is on every update feeds a per-tenant traffic ledger
(:class:`_TenantTraffic`: rows routed and the last time each tenant was
seen) behind :meth:`KeyedMetric.tenant_report`. The ledger lives on the
update's device and is fed the merge's (else B3's, B4's or the plain
route's) per-tenant row counts (three device operations per update); it is
read to the host only when a report asks, so a keyed update makes the same
synchronizing calls with telemetry on as off. (The JAX package reads the ids on the host
instead.) The admission queue's staged host view carries its device twin
(``device_tensor``): the twin is what the update dispatches, and the host
view validates the ids without a read.

Elastic capacity and durability (``multitenant.py:697-1040,1337,1603-1650``):
:meth:`KeyedMetric.grow`/:meth:`KeyedMetric.compact` (and the collection's)
resize the tenant axis to power-of-two capacities, so the compiled keyed
update captures once per capacity it passes through. A durability actor
installs itself as ``_durability_hooks`` (the cold-tenant spiller,
:mod:`metrics_tpu_torch.durability.spill`): the stateful paths call its
``before_update``/``after_update`` around each scatter (with the staged host
view of the ids when there is one, else the id tensor), ``before_read``
before a compute, ``before_snapshot`` before a copy or a resize and
``on_resize`` after one; a checkpoint restore calls ``on_restore``. A
checkpoint trail or a spiller pins the traffic ledger open
(``_durability_traffic_pin``), so updates feed it with telemetry off.
"""
import copy
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.kernels._common import note_kernel_dispatch
from metrics_tpu_torch.kernels.segment_scatter import (
    MERGE_DTYPES,
    _counts,
    _safe_ids,
    segment_extremal_plain,
    segment_merge_cuda,
    segment_scatter_add_cuda,
    segment_scatter_max_cuda,
    segment_scatter_min_cuda,
    segment_sum_plain,
)
from metrics_tpu_torch.metric import (
    Metric,
    StateDict,
    _aliased_leaf,
    _microbatch_len,
    _note_compiled_dispatch,
    _unrolled,
    _warmup_report,
)
from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.health import HEALTH, guard_state
from metrics_tpu_torch.observability.histogram import observe_dispatch
from metrics_tpu_torch.observability.memory import LEDGER
from metrics_tpu_torch.observability.profiling import PROFILER
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.observability.retrace import MONITOR, arg_signature
from metrics_tpu_torch.observability.tracing import TRACER, span
from metrics_tpu_torch.utilities.aot import CompiledDispatch, GraphPool
from metrics_tpu_torch.utilities.data import (
    Tensor,
    _counts_traces,
    _is_traced,
    check_device,
    resolve_device,
    to_host,
)
from metrics_tpu_torch.utilities.profiling import compiled_scope
from metrics_tpu_torch.utilities.stacked import broadcast_stack, row_states, vmap_compute

__all__ = ["KeyedMetric", "MultiTenantCollection"]

#: reductions the segment router can route exactly (see :func:`_keyed_gate`)
_SEGMENT_REDUCTIONS = ("sum", "max", "min")
#: sum-leaf dtypes outside the merge that B3 accumulates exactly through its
#: float32 rows (others take the plain ``index_add_`` in their own dtype)
_FUSED_SCATTER_DTYPES = (torch.bfloat16,)
#: extremal-leaf dtypes outside the merge that B4 picks exactly through its
#: float32 rows (others take the plain ``scatter_reduce_`` in their own dtype)
_EXTREMAL_SCATTER_DTYPES = (torch.bfloat16, torch.int16, torch.int8)


class _ScatterPlan(NamedTuple):
    """A bundle's routes, fixed by its leaves' dtypes and reductions."""

    #: ``(name, reduction, default)`` of the int32/float32 leaves: the merge
    merged: Tuple[Tuple[str, str, Tensor], ...]
    #: the other ``"sum"`` leaves by the dtype they are added in: float32
    #: (B3, the bfloat16 leaves), else their own (the plain route)
    sums: Dict[torch.dtype, List[str]]
    #: the other ``"max"``/``"min"`` leaves: B4's first, then the plain route's
    extremal: Tuple[str, ...]
    #: how many of ``extremal`` B4 takes
    b4: int
    #: a leaf takes a plain route
    plain: bool
    #: a leaf outside the merge takes B3 or B4, which give the row counts
    kernel: bool


def _scatter_bundles(bundles: Sequence[Tuple["KeyedMetric", StateDict, StateDict]], ids: Tensor, n: int,
                     device: torch.device) -> Tuple[List[StateDict], Tensor, Optional[Tensor]]:
    """The scatter of one keyed update over ``(keyed bundle, stacked state,
    per-row states)`` triples sharing ``ids`` and the capacity ``n``: ONE
    merge launch over the int32/float32 leaves of every bundle, then each
    bundle's other leaves (:meth:`KeyedMetric._scatter_rest`). Returns the
    new stacked states, the invalid-id count and the per-tenant row counts
    (the merge's, else the first bundle's)."""
    leaves = []
    for keyed, state, per_row in bundles:
        for name, fx, default in keyed._scatter_plan().merged:
            rows = per_row[name]
            leaves.append((rows if rows.dtype == default.dtype else rows.to(default.dtype), state[name], default, fx))
    counts = invalid = None
    outs: List[Tensor] = []
    if leaves:
        outs, counts, invalid = segment_merge_cuda(leaves, ids, n, device=device)
        TRACER.note_merged_leaves(len(leaves))
    merged = iter(outs)
    news = []
    for keyed, state, per_row in bundles:
        new = {name: next(merged) for name, _, _ in keyed._scatter_plan().merged}
        counts = keyed._scatter_rest(state, ids, per_row, new, counts)
        news.append({name: new[name] for name in keyed._child._reductions})
    if invalid is None:
        invalid = torch.sum((ids < 0) | (ids >= n)).to(torch.int32)
    return news, invalid, counts


def _pow2_at_least(n: int) -> int:
    """The smallest power of two >= ``n`` (>= 1) — the padded-capacity
    discipline of the elastic API (``grow``/``compact``)."""
    return 1 << max(0, int(n) - 1).bit_length()


def _note_keyed_update(obj: Any, start: float, rows: int, **payload: Any) -> None:
    """The keyed update's telemetry (``multitenant.py:719-745``): rows,
    dispatch count and host time, and the ``keyed_scatter`` event."""
    dur = time.perf_counter() - start
    key = obj.telemetry_key
    if TELEMETRY.enabled:
        TELEMETRY.inc(key, "keyed_update_rows", rows)
        TELEMETRY.inc(key, "keyed_update_dispatches")
        observe_dispatch(dur, "keyed_scatter")
    if EVENTS.enabled:
        EVENTS.record(
            "update", key, dur_s=dur, t_start=start, path="keyed_scatter", tenants=obj.num_tenants, rows=rows,
            **payload,
        )


#: the compiled dispatches of a MultiTenantCollection (each with its copying twin)
_MTC_DISPATCHES = ("_keyed_update_fn", "_keyed_update_fn_copy", "_update_many_fn", "_update_many_fn_copy")


def _note_keyed_compiled(obj: Any, fn: CompiledDispatch, start: Optional[float], args: Tuple, kwargs: Dict,
                         **payload: Any) -> None:
    """The compiled keyed update's telemetry (``multitenant.py:726-760``);
    ``args`` (the ids first) and ``kwargs`` are the dispatch's."""
    if start is None:
        return
    dur = time.perf_counter() - start
    key = obj.telemetry_key
    rows = int(args[0].shape[0])
    if TELEMETRY.enabled:
        TELEMETRY.inc(key, "keyed_update_rows", rows)
        observe_dispatch(dur, "keyed_scatter")
        _note_compiled_dispatch(obj, fn, args, kwargs, counter="keyed_update_dispatches")
    EVENTS.record(
        "update", key, dur_s=dur, t_start=start, path="keyed_scatter", tenants=obj.num_tenants, rows=rows,
        compiled_this_call=bool(fn.last_compiled), donated=fn.donate_state, **payload,
    )


def _stacked_ids(owner: Any, tenant_ids: Any) -> Tensor:
    """``update_many``'s ``(K, B)`` tenant ids as an integer tensor on the
    owner's device."""
    ids = _unstage(tenant_ids)
    ids = ids if isinstance(ids, Tensor) else torch.as_tensor(np.asarray(ids), device=owner.device)
    check_device(owner.device, ids)
    if ids.dtype.is_floating_point or ids.is_complex() or ids.dtype == torch.bool:
        raise ValueError(f"tenant_ids must be an integer array, got dtype {ids.dtype}")
    if ids.ndim != 2:
        raise ValueError(f"update_many's tenant_ids must be (K, B), got shape {tuple(ids.shape)}")
    return ids if ids.dtype in (torch.int32, torch.int64) else ids.long()


def _unstage(x: Any) -> Any:
    """Swap the admission queue's staged host view (``serving/staging.py``)
    for its device twin; anything else passes through. Duck-typed on the
    ``device_tensor`` attribute, so this module never imports serving."""
    staged = getattr(x, "device_tensor", None)
    return x if staged is None else staged


class _TenantTraffic:
    """Per-tenant traffic and staleness ledger behind ``tenant_report()``
    (``multitenant.py:156-300``).

    Per tenant: the event rows routed (``rows``, int64) and the wall-clock
    instant of the last routed row (``last_seen``, float64, NaN where never
    seen), two tensors on the update's device, allocated on the first note.
    An update feeds them the per-tenant row counts its segment-scatter kernel
    already computed (:meth:`note`: the counts added in, one host
    ``time.time()`` filled in where a count is non-zero), so the ledger never
    reads the ids on the host: on a card it costs no synchronizing call, and
    invalid ids are dropped as the kernels drop them. :meth:`arrays` reads
    both to the host in one transfer. Every mutation and read runs under one
    lock: the admission queue's flusher notes while readers report on other
    threads.
    """

    __slots__ = ("n", "rows", "last_seen", "_lock")

    def __init__(self, n: int) -> None:
        self.n = int(n)
        self.rows: Optional[Tensor] = None
        self.last_seen: Optional[Tensor] = None
        self._lock = threading.Lock()

    def __getstate__(self) -> dict:
        # the lock is process-local: pickles and clones make a fresh one
        with self._lock:
            return {k: getattr(self, k) for k in self.__slots__ if k != "_lock"}

    def __setstate__(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)
        self._lock = threading.Lock()

    def note(self, counts: Tensor) -> None:
        """Note one update from its per-tenant row counts (a ``(>= n,)``
        integer tensor on the update's device, invalid rows not counted)."""
        counts = counts[: self.n]
        stamp = time.time()
        with self._lock:
            if self.rows is None:
                self.rows = torch.zeros(self.n, dtype=torch.int64, device=counts.device)
                self.last_seen = torch.full((self.n,), float("nan"), dtype=torch.float64, device=counts.device)
            self.rows += counts
            self.last_seen.masked_fill_(counts > 0, stamp)

    def resize(self, new_n: int) -> None:
        """Resize to ``new_n`` tenants, keeping the overlapping prefix's
        counts and stamps (``multitenant.py:213``, the elastic grow/compact
        path); tenants at or past ``new_n`` are dropped as compaction drops
        their rows. On the device, no read."""
        new_n = int(new_n)
        with self._lock:
            old_rows, old_seen, keep = self.rows, self.last_seen, min(self.n, new_n)
            self.n = new_n
            if old_rows is None:
                return
            self.rows = old_rows.new_zeros(new_n)
            self.last_seen = old_seen.new_full((new_n,), float("nan"))
            self.rows[:keep] = old_rows[:keep]
            self.last_seen[:keep] = old_seen[:keep]

    def marks(self) -> Optional[Tensor]:
        """A device copy of the routed-row counts (``None`` when nothing was
        recorded): the checkpoint plane's write marks, cut without a read."""
        with self._lock:
            return None if self.rows is None else self.rows.clone()

    def restore(self, rows: np.ndarray, device: torch.device) -> None:
        """Install saved routed-row counts (a checkpoint restore); the stamps
        restart unseen."""
        with self._lock:
            self.rows = torch.zeros(self.n, dtype=torch.int64, device=device)
            k = min(len(rows), self.n)
            self.rows[:k] = torch.as_tensor(np.asarray(rows[:k], dtype=np.int64), device=device)
            self.last_seen = torch.full((self.n,), float("nan"), dtype=torch.float64, device=device)

    def arrays(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """One consistent ``(rows, last_seen)`` host copy (``(None, None)``
        when nothing was recorded), read in one transfer."""
        with self._lock:
            if self.rows is None:
                return None, None
            # both tensors in one read: the stamps ride as their int64 bits
            both = to_host(torch.cat([self.rows, self.last_seen.view(torch.int64)]), numpy=True)
        return both[: self.n], both[self.n:].view(np.float64)

    def clear(self, ids: Optional[Tensor] = None) -> None:
        with self._lock:
            if ids is None:
                self.rows = self.last_seen = None
            elif self.rows is not None:
                idx = ids.reshape(-1).to(self.rows.device)
                self.rows[idx] = 0
                self.last_seen[idx] = float("nan")

    def report(self, top_k: int, invalid: int) -> Dict[str, Any]:
        """The drill-down dict (see ``KeyedMetric.tenant_report``), built from
        one consistent copy of the ledger."""
        now = time.time()
        n = self.n
        rows, last_seen = self.arrays()
        tracking = rows is not None
        if not tracking:
            rows = np.zeros(n, dtype=np.int64)
        active_mask = rows > 0
        active = int(active_mask.sum())
        rows_total = int(rows.sum())
        k = max(0, min(int(top_k), n))
        top: List[Dict[str, Any]] = []
        if rows_total and k:
            order = np.argsort(rows)[::-1][:k]
            top = [{"tenant": int(i), "rows": int(rows[i])} for i in order if rows[i] > 0]
        staleness: Dict[str, Any] = {"p50": None, "p95": None, "max": None}
        stalest: List[Dict[str, Any]] = []
        if active and last_seen is not None:
            ages = now - last_seen[active_mask]
            staleness = {
                "p50": round(float(np.percentile(ages, 50)), 6),
                "p95": round(float(np.percentile(ages, 95)), 6),
                "max": round(float(ages.max()), 6),
            }
            active_ids = np.nonzero(active_mask)[0]
            order = np.argsort(ages)[::-1][: min(k, active)]
            stalest = [{"tenant": int(active_ids[i]), "age_s": round(float(ages[i]), 6)} for i in order]
        routed_plus_invalid = rows_total + int(invalid)
        return {
            "tenants": n,
            "tracking": tracking,
            "rows_routed": rows_total,
            "occupancy": {"active": active, "fraction": round(active / n, 6) if n else 0.0},
            "top_traffic": top,
            "invalid_tenant_ids": int(invalid),
            "invalid_rate": round(int(invalid) / routed_plus_invalid, 6) if routed_plus_invalid else 0.0,
            "staleness_s": staleness,
            "stalest": stalest,
            "generated_unix_s": round(now, 3),
        }


def _publish_tenant_report(key: str, report: Dict[str, Any]) -> None:
    """Land a tenant report's compact rollup on the snapshot (the
    ``tenant_report`` info blob the Prometheus renderer reads) and the event
    timeline (``multitenant.py:302-314``)."""
    compact = {
        "tenants": report["tenants"],
        "rows_routed": report["rows_routed"],
        "occupancy": report["occupancy"],
        "invalid_rate": report["invalid_rate"],
    }
    if TELEMETRY.enabled:
        TELEMETRY.set_info(key, "tenant_report", compact)
    if EVENTS.enabled:
        EVENTS.record("tenant_report", key, **compact)


def _serial_lock(obj: Any) -> "threading.RLock":
    """``obj``'s stateful-update lock: lazy and process-local (never in a
    pickle or a clone), made once even when threads race to make it."""
    lock = obj.__dict__.get("_ingest_lock")
    if lock is None:
        lock = obj.__dict__.setdefault("_ingest_lock", threading.RLock())
    return lock


def _ledger_fed(obj: Any) -> bool:
    """Whether an update feeds ``obj``'s traffic ledger: while telemetry is
    on, or while a durability actor (a checkpoint trail, a spiller) pins the
    ledger open (``multitenant.py:719-722``): frozen counts would drop
    tenants from the next delta's dirty set."""
    return TELEMETRY.enabled or bool(obj.__dict__.get("_durability_traffic_pin"))


def _keyed_gate(metric: Metric, what: str = "base_metric") -> None:
    """Raise a descriptive ``ValueError`` when ``metric`` cannot be keyed.

    Keying needs fixed-shape leaves whose reductions the segment router can
    express (``"sum"`` through B3, ``"max"``/``"min"`` through B4, each in
    its own dtype by the plain route where the kernels do not take it
    exactly) and the base pure-state protocol. Unbounded list states,
    ``"cat"``/``"mean"``/custom reductions and ``dist_sync_on_step`` all
    stay single-stream.

    int32 ``"sum"`` leaves take the merge's integer atomics, exact at any
    size. bfloat16 ``"sum"`` leaves reach B3 as float32 deltas, so they are
    exact only while each tenant's sum of one leaf element within one batch
    stays below 2^24; nothing checks that bound at run time.
    """
    if not isinstance(metric, Metric):
        raise ValueError(f"Expected {what} to be a metrics_tpu_torch.Metric, got {metric!r}")
    name = type(metric).__name__
    if not metric._defaults:
        raise ValueError(
            f"{what} {name} registers no states, so there is nothing to key per"
            " tenant (compositions key their children instead)."
        )
    hint = f" {metric._sketch_hint}" if metric._sketch_hint else ""
    if any(isinstance(v, list) for v in metric._defaults.values()):
        raise ValueError(
            f"{what} {name} holds unbounded list states, whose size grows every"
            " step; keyed state must be fixed-shape — use the metric's"
            f" `capacity=`/`streaming=` mode, or keep per-tenant instances.{hint}"
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
            f" reductions stay single-stream.{hint}"
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
            the padding off. :meth:`grow`/:meth:`compact` change both.
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
        self._traffic = _TenantTraffic(self.num_tenants)

    @property
    def capacity(self) -> int:
        """Physical tenant-axis size of the stacked leaves (>= ``num_tenants``)."""
        return self._capacity

    def _serial_lock(self) -> "threading.RLock":
        """The stateful-update lock (``multitenant.py:433-441``): concurrent
        ingest threads calling ``update`` would otherwise interleave their
        read-modify-write of the stacked state. The pure ``apply_update``
        never takes it."""
        return _serial_lock(self)

    # ------------------------------------------------------------------
    # tenant-id canonicalization / validation
    # ------------------------------------------------------------------

    def _canonical_ids(self, tenant_ids: Any) -> Tensor:
        # a staged cohort (serving/staging.py) carries its device twin: the
        # update dispatches the twin, so no second copy to the card
        tenant_ids = _unstage(tenant_ids)
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

    def _validate_ids_eager(self, ids: Any) -> None:
        """Id check of the stateful path: descriptive raise. Host ids (a
        staged cohort's host view) are checked on the host; a tensor in one
        host read."""
        if isinstance(ids, np.ndarray):
            bad_host = (ids < 0) | (ids >= self.num_tenants)
            first = int(np.argmax(bad_host)) if bad_host.size else 0
            count, value = int(bad_host.sum()), int(ids[first]) if bad_host.size else 0
        elif ids.numel() == 0:
            return
        else:
            bad = (ids < 0) | (ids >= self.num_tenants)
            first = torch.argmax(bad.to(torch.int32))
            count, first, value = to_host(torch.stack([bad.sum(), first, ids[first].long()]))
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
        """Pure keyed update core: ``(new_stacked_state, invalid_count)``
        (see :meth:`_scatter_counted`)."""
        new_state, invalid, _ = self._scatter_counted(state, ids, args, kwargs)
        return new_state, invalid

    def _scatter_counted(
        self, state: StateDict, ids: Tensor, args: Tuple, kwargs: Dict
    ) -> Tuple[StateDict, Tensor, Tensor]:
        """``(new_stacked_state, invalid_count, counts)``: the keyed update
        and the ``(capacity,)`` int32 row counts per tenant (the traffic
        ledger's feed) of the merge, else of the first kernel launched, B3
        before B4.

        The kernels drop ids < 0 or >= the PHYSICAL capacity; an id in the
        padding band ``[num_tenants, capacity)`` lands in a padding row, which
        compute slices off. ``invalid_count`` stays on the device.

        Leaves outside the merge take B3, B4 or the plain route in their own
        dtype (see the module docstring). A bundle with no leaf for any
        kernel gets its counts from a plain ``index_add_`` of its valid rows
        into int32, on the device: no update reads an id to the host, so
        every route can be captured.

        Its host spans: ``checks`` and ``row_states`` (:meth:`_bundle_rows`)
        and ``scatter`` (:func:`_scatter_bundles`: one merge launch).
        """
        per_row = self._bundle_rows(args, kwargs)
        with span("scatter"):
            (new,), invalid, counts = _scatter_bundles(((self, state, per_row),), ids, self._capacity, self.device)
        return new, invalid, counts

    def _bundle_rows(self, args: Tuple, kwargs: Dict) -> StateDict:
        """The child's input checks on the whole batch (the ``checks`` span;
        they raise before any state changes) and its per-row states
        (:func:`~metrics_tpu_torch.utilities.stacked.row_states`)."""
        child = self._child
        if not _is_traced():
            with span("checks"):
                child._validate_batch(*args, **kwargs)
        return row_states(child, args, kwargs)

    def _scatter_plan(self) -> _ScatterPlan:
        """The bundle's routes by leaf dtype and reduction, built at the first
        update: int32 and float32 leaves take the merge; bfloat16 sums B3;
        bfloat16, int16 and int8 extrema B4; the rest the plain routes."""
        plan = self.__dict__.get("_plan")
        if plan is None:
            child = self._child
            merged, sums, b4, plain_extremal = [], {}, [], []
            for name, fx in child._reductions.items():
                default = child._defaults[name]
                if default.dtype in MERGE_DTYPES:
                    merged.append((name, fx, default.contiguous()))
                elif fx == "sum":
                    fused = default.dtype in _FUSED_SCATTER_DTYPES
                    sums.setdefault(torch.float32 if fused else default.dtype, []).append(name)
                elif default.dtype in _EXTREMAL_SCATTER_DTYPES:
                    b4.append(name)
                else:
                    plain_extremal.append(name)
            plain = bool(plain_extremal) or any(dtype != torch.float32 for dtype in sums)
            plan = self.__dict__["_plan"] = _ScatterPlan(
                tuple(merged), sums, tuple(b4 + plain_extremal), len(b4), plain, torch.float32 in sums or bool(b4))
        return plan

    def _scatter_rest(self, state: StateDict, ids: Tensor, per_row: StateDict, new: StateDict,
                      counts: Optional[Tensor]) -> Optional[Tensor]:
        """The leaves outside the merge routed into ``new``: the bfloat16 sums
        packed into columns through B3, the other sums by dtype through the
        plain route, the extrema through B4 or the plain route, merged where
        a tenant has rows. Returns the row counts: ``counts`` (the merge's
        or an earlier bundle's) where given, else those of this bundle's
        first kernel or of the plain route."""
        plan = self._scatter_plan()
        child = self._child
        n = self._capacity
        if plan.plain or (counts is None and not plan.kernel):
            # the plain route's ids (made only where a leaf takes it), and the
            # row counts where nothing else gives them
            valid, safe = _safe_ids(ids, n)
            if counts is None and not plan.kernel:
                counts = _counts(valid, safe, n)
                note_kernel_dispatch("segment_scatter_add", "plain")
        for dtype, names in plan.sums.items():
            layout, columns = [], []
            for name in names:
                delta = per_row[name] - child._defaults[name]
                flat = delta.reshape(delta.shape[0], -1).to(dtype)
                layout.append((name, tuple(delta.shape[1:]), flat.shape[1]))
                columns.append(flat)
            packed = torch.cat(columns, dim=1)
            if dtype == torch.float32:
                packed, seg_counts = segment_scatter_add_cuda(packed.contiguous(), ids, n, device=self.device)
                counts = seg_counts if counts is None else counts
            else:
                packed = segment_sum_plain(packed, safe, n)
                note_kernel_dispatch("segment_scatter_add", "plain")
            offset = 0
            for name, shape, width in layout:
                delta = packed[:, offset:offset + width].reshape((n,) + shape)
                new[name] = state[name] + delta.to(state[name].dtype)
                offset += width
        for i, name in enumerate(plan.extremal):
            fx, rows = child._reductions[name], per_row[name]
            pick = torch.maximum if fx == "max" else torch.minimum
            flat = rows.reshape(rows.shape[0], -1)
            if i < plan.b4:
                kernel = segment_scatter_max_cuda if fx == "max" else segment_scatter_min_cuda
                seg, seg_counts = kernel(flat.to(torch.float32).contiguous(), ids, n, device=self.device)
                counts = seg_counts if counts is None else counts
            else:
                seg, seg_counts = segment_extremal_plain(flat, safe, n, fx), counts
                note_kernel_dispatch(f"segment_scatter_{fx}", "plain")
            seg = seg.reshape((n,) + tuple(rows.shape[1:]))
            has_rows = (seg_counts > 0).reshape((n,) + (1,) * (rows.ndim - 1))
            new[name] = torch.where(has_rows, pick(state[name], seg.to(state[name].dtype)), state[name])
        return counts

    # ------------------------------------------------------------------
    # pure and stateful API
    # ------------------------------------------------------------------

    def apply_update(self, state: StateDict, tenant_ids: Any, *args: Any, **kwargs: Any) -> StateDict:
        """Pure keyed update: the stacked state advanced by one mixed event
        batch; invalid ids are dropped (this path never raises on them) and
        counted under ``invalid_tenant_ids`` while telemetry is on (outside
        a compiled program: its dispatch counts them from the program's
        output)."""
        if TELEMETRY.enabled and _counts_traces():
            TELEMETRY.inc(self.telemetry_key, "update_traces")
            MONITOR.note_trace(self.telemetry_key, arg_signature(tenant_ids, *args, **kwargs))
        with compiled_scope(f"{type(self._child).__name__}.keyed_update"):
            new_state, invalid = self._segment_scatter(state, self._canonical_ids(tenant_ids), args, kwargs)
        if not _is_traced():
            TELEMETRY.add_device(self.telemetry_key, "invalid_tenant_ids", invalid)
        if HEALTH.enabled:
            guard_state(self, new_state, source="apply_update")
        return new_state

    # -- the compiled keyed update ---------------------------------------------

    def _dispatch_scatter(self, state: StateDict, ids: Tensor, *args: Any, **kwargs: Any
                          ) -> Tuple[StateDict, Tuple[Tensor, Tensor]]:
        """The program behind the compiled ``update`` (``multitenant.py:625``):
        ``(new state, (invalid count, per-tenant row counts))``."""
        new_state, invalid, counts = self._scatter_counted(state, ids, args, kwargs)
        return new_state, (invalid, counts)

    def _scan_update_many(self, state: StateDict, stacked: Tuple, stacked_kwargs: Dict
                          ) -> Tuple[StateDict, Tuple[Tensor, Tensor]]:
        """K keyed updates unrolled into one program; their invalid counts
        and per-tenant row counts summed."""
        totals: List[Tensor] = []

        def step(s: StateDict, ids: Tensor, *args: Any, **kwargs: Any) -> StateDict:
            if TELEMETRY.enabled and _counts_traces():  # as the JAX scan traces apply_update
                TELEMETRY.inc(self.telemetry_key, "update_traces")
            new, invalid, counts = self._scatter_counted(s, ids, args, kwargs)
            totals[:] = [invalid, counts] if not totals else [totals[0] + invalid, totals[1] + counts]
            if HEALTH.enabled:  # the JAX scan's apply_update guards each step's stacked state
                guard_state(self, new, source="apply_update")
            return new

        return _unrolled(step, state, stacked, stacked_kwargs), (totals[0], totals[1])

    def jit_forward(self, enable: bool = True, donate: bool = True) -> "KeyedMetric":
        """:meth:`Metric.jit_forward`, and the compiled keyed ``update``
        (one graph per batch signature) with it."""
        super().jit_forward(enable, donate)
        self._keyed_compiled = bool(enable)
        return self

    def _drop_compiled_dispatch(self) -> None:
        super()._drop_compiled_dispatch()
        self.__dict__["_keyed_update_fn"] = None
        self.__dict__["_keyed_update_copy_fn"] = None

    def _keyed_dispatch(self, donate: bool) -> CompiledDispatch:
        name = "_keyed_update_fn" if donate else "_keyed_update_copy_fn"
        fn = self.__dict__.get(name)
        if fn is None:
            fn = CompiledDispatch(self._dispatch_scatter, donate_state=donate, pool=self._pool(),
                                  owner_refs=self._dispatch_refs)
            self.__dict__[name] = fn
        return fn

    def _after_keyed_dispatch(self, invalid: Tensor, counts: Tensor) -> None:
        if _ledger_fed(self):
            self._traffic.note(counts)
        if TELEMETRY.enabled:
            TELEMETRY.add_device(self.telemetry_key, "invalid_tenant_ids", invalid)

    def _update_compiled(self, ids: Tensor, args: Tuple, kwargs: Dict, hook_ids: Any = None) -> None:
        start = time.perf_counter() if (TELEMETRY.enabled or EVENTS.enabled) else None
        hooks = self.__dict__.get("_durability_hooks")
        with self._serial_lock():
            if hooks is not None:
                hooks.before_update(ids if hook_ids is None else hook_ids)
            self._computed = None
            state = self._get_states()
            donatable = False
            if self._jit_forward_donate:
                state, donatable = self._donation_safe_state(state)
            fn = self._keyed_dispatch(donatable)
            prof = PROFILER.begin("keyed_scatter", self.device)
            new_state, (invalid, counts) = fn(state, ids, *args, **kwargs)
            if prof is not None:
                PROFILER.finish(prof, self.telemetry_key, fn)
            self._set_states(new_state)
            self._update_called = True
            if hooks is not None:
                hooks.after_update(ids if hook_ids is None else hook_ids)
        self._after_keyed_dispatch(invalid, counts)
        _note_keyed_compiled(self, fn, start, (ids, *args), kwargs)

    def warmup(self, tenant_ids: Any, *sample_batch: Any, **kwargs: Any) -> Dict[str, Any]:
        """Capture the compiled keyed update for this batch's signature
        (``multitenant.py:764``; see :meth:`Metric.warmup`), which ``update``
        then replays. The state does not change."""
        self._keyed_compiled = True
        ids = self._canonical_ids(tenant_ids)
        sample_batch = tuple(_unstage(a) for a in sample_batch)
        kwargs = {k: _unstage(v) for k, v in kwargs.items()}
        fn = self._keyed_dispatch(self._jit_forward_donate)
        start = time.perf_counter()
        with self._serial_lock():
            fresh = fn.warm(self._get_states(), ids, *sample_batch, **kwargs)
        return _warmup_report(self, fn, fresh, start, arg_signature(ids, *sample_batch, **kwargs),
                              f"KeyedMetric({type(self._child).__name__})", self.state_memory_report(),
                              program="update", tenants=self.num_tenants)

    def update_many(self, tenant_ids: Any, *stacked: Any, **stacked_kwargs: Any) -> None:
        """K stacked keyed cohorts in ONE compiled dispatch
        (``multitenant.py:746``): ``tenant_ids`` is ``(K, B)``, every tensor
        argument has a matching leading K; the eager id check covers the
        whole stack first (``validate_ids=True``)."""
        ids = _stacked_ids(self, tenant_ids)
        if self.validate_ids:
            self._validate_ids_eager(ids.reshape(-1))
        stacked = tuple(_unstage(a) for a in stacked)
        stacked_kwargs = {k: _unstage(v) for k, v in stacked_kwargs.items()}
        hooks = self.__dict__.get("_durability_hooks")
        with self._serial_lock():
            if hooks is not None:
                hooks.before_update(ids.reshape(-1))
            invalid, counts = self._dispatch_update_many((ids,) + stacked, stacked_kwargs)
            if hooks is not None:
                hooks.after_update(ids.reshape(-1))
        self._after_keyed_dispatch(invalid, counts)

    def update(self, tenant_ids: Any, *args: Any, **kwargs: Any) -> None:
        """Route one mixed event batch to every tenant.

        ``tenant_ids`` is a rank-1 integer tensor aligned with the leading
        event-row axis of every tensor argument. With ``validate_ids=True``
        (default) out-of-range ids raise here, before anything is scattered;
        with ``False`` the kernels drop them. A staged cohort (the admission
        queue's host views carrying ``device_tensor`` twins) dispatches the
        twins; its host view keeps the id check free of host reads.
        Concurrent callers are serialized.
        """
        compiled = bool(self.__dict__.get("_keyed_compiled"))
        with span("keyed.update", bundles=1, path="compiled" if compiled else "eager") as request:
            host_ids = tenant_ids if getattr(tenant_ids, "device_tensor", None) is not None else None
            ids = self._canonical_ids(tenant_ids)
            request.note(rows=int(ids.shape[0]))
            if self.validate_ids:
                self._validate_ids_eager(ids if host_ids is None else host_ids)
            args = tuple(_unstage(a) for a in args)
            kwargs = {k: _unstage(v) for k, v in kwargs.items()}
            if compiled:
                self._check_input_device(args, kwargs)
                return self._update_compiled(ids, args, kwargs, host_ids)
            start = time.perf_counter() if (TELEMETRY.enabled or EVENTS.enabled) else None
            hooks = self.__dict__.get("_durability_hooks")
            with self._serial_lock():
                if hooks is not None:
                    # spilled tenants named in this batch fault back before the
                    # scatter reads the stacked state
                    hooks.before_update(ids if host_ids is None else host_ids)
                prof = PROFILER.begin("keyed_scatter", self.device)
                new_state, invalid, counts = self._scatter_counted(self._get_states(), ids, args, kwargs)
                if prof is not None:
                    PROFILER.finish(prof, self.telemetry_key)
                self._set_states(new_state)
                if hooks is not None:
                    hooks.after_update(ids if host_ids is None else host_ids)
            if _ledger_fed(self):
                self._traffic.note(counts)
            if start is not None:
                TELEMETRY.add_device(self.telemetry_key, "invalid_tenant_ids", invalid)
                _note_keyed_update(self, start, int(ids.shape[0]))

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
        Padding rows past ``num_tenants`` are sliced off; spilled tenants
        fault back first (:mod:`metrics_tpu_torch.durability.spill`)."""
        hooks = self.__dict__.get("_durability_hooks")
        if hooks is not None:
            hooks.before_read()
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

    def tenant_report(self, top_k: int = 10) -> Dict[str, Any]:
        """Per-tenant drill-down from the traffic ledger (``multitenant.py:868``).

        Occupancy (tenants that received a row, count and fraction), the
        ``top_k`` tenants by rows routed (``{"tenant", "rows"}``), the
        ``invalid_tenant_ids`` counter and its rate over all routed rows, and
        last-update staleness: p50/p95/max age in seconds over active tenants
        and the ``top_k`` stalest. The ledger is fed while telemetry is on
        (``tracking`` is ``False`` when nothing was recorded); the ledger and
        the invalid-id count are read to the host here. The compact
        rollup lands on the snapshot (``tenant_report`` info blob, the
        ``metrics_tpu_tenants*`` series) and the event timeline.
        """
        invalid = TELEMETRY.counter(self.telemetry_key, "invalid_tenant_ids")
        report = self._traffic.report(top_k, invalid)
        report["metric"] = f"KeyedMetric({type(self._child).__name__})"
        _publish_tenant_report(self.telemetry_key, report)
        return report

    # ------------------------------------------------------------------
    # elastic tenant capacity
    # ------------------------------------------------------------------

    def _resize(self, num_tenants: int, new_capacity: int) -> None:
        """Re-stack every leaf to ``new_capacity`` rows (logical size
        ``num_tenants``), keeping the overlapping tenant prefix's
        accumulation (``multitenant.py:899``). Spilled tenants fault back
        first.

        A new capacity makes new state tensors, so the compiled keyed update
        lands on a new key (the state's shapes are part of it) and captures
        once per capacity; the graphs of earlier capacities stay cached, so a
        service that grows and compacts captures at most once per power of
        two it passes through. Within one capacity the rows leaving or
        entering the logical band are reset to the defaults in place, under
        the tensors a held graph writes."""
        num_tenants, new_capacity = int(num_tenants), int(new_capacity)
        if num_tenants < 1:
            raise ValueError(f"num_tenants must be >= 1, got {num_tenants}")
        if new_capacity < num_tenants:
            raise ValueError(f"capacity ({new_capacity}) must be >= num_tenants ({num_tenants})")
        hooks = self.__dict__.get("_durability_hooks")
        with self._serial_lock():
            if hooks is not None:
                hooks.before_snapshot()
            keep = min(self.num_tenants, num_tenants)
            child_defaults = self._child._defaults
            if new_capacity != self._capacity:
                new_state: StateDict = {}
                for name, stacked in broadcast_stack(dict(child_defaults), new_capacity).items():
                    leaf = stacked.clone()
                    leaf[:keep].copy_(getattr(self, name)[:keep])
                    new_state[name] = leaf
                    self._defaults[name] = stacked
                self._set_states(new_state)
            else:
                lo, hi = keep, max(self.num_tenants, num_tenants)
                if hi > lo:
                    for name, default in child_defaults.items():
                        getattr(self, name)[lo:hi].copy_(default.expand((hi - lo,) + tuple(default.shape)))
            self.num_tenants = num_tenants
            self._capacity = new_capacity
            self._traffic.resize(num_tenants)
            self._computed = None
            self._forward_cache = None
            if hooks is not None:
                hooks.on_resize(num_tenants)
        # outside the serial lock: a pressure callback may evict, which takes it
        LEDGER.note(self)

    def grow(self, num_tenants: int) -> int:
        """Grow the logical tenant axis to ``num_tenants`` (a smaller value is
        a no-op), keeping every tenant's accumulation. The physical capacity
        pads to the next power of two, so the compiled keyed update captures
        at most ``log2(max N) + 1`` times. Returns the new capacity."""
        target = int(num_tenants)
        if target <= self.num_tenants:
            return self._capacity
        new_capacity = max(self._capacity, _pow2_at_least(target))
        self._resize(target, new_capacity)
        from metrics_tpu_torch.durability.telemetry import note_resize

        note_resize(self.telemetry_key, "grow", target, new_capacity)
        return self._capacity

    def compact(self, num_tenants: Optional[int] = None) -> int:
        """Shrink the tenant axis to ``num_tenants`` (default: the highest
        tenant that ever received a row, +1, read from the traffic ledger),
        dropping the tail tenants' accumulation; the capacity becomes the
        smallest power of two that holds the survivors. Returns it."""
        if num_tenants is None:
            rows, _ = self._traffic.arrays()
            active = np.nonzero(rows)[0] if rows is not None else np.array([], np.int64)
            num_tenants = int(active[-1]) + 1 if active.size else 1
        target = int(num_tenants)
        if target > self.num_tenants:
            raise ValueError(
                f"compact target ({target}) exceeds the current tenant count"
                f" ({self.num_tenants}); use grow() to add tenants"
            )
        new_capacity = _pow2_at_least(target)
        self._resize(target, new_capacity)
        from metrics_tpu_torch.durability.telemetry import note_resize

        note_resize(self.telemetry_key, "compact", target, new_capacity)
        return self._capacity

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def reset(self, tenant_ids: Optional[Any] = None) -> None:
        """Restore every tenant — or only ``tenant_ids`` — to the defaults,
        and clear their traffic.

        The partial form writes the child defaults into the named rows of
        every stacked leaf (out of place), leaving all other tenants'
        accumulation intact; its ids always validate."""
        if tenant_ids is None:
            self._traffic.clear()
            return super().reset()
        ids = self._canonical_ids(tenant_ids)
        self._validate_ids_eager(ids)
        self._traffic.clear(ids)
        new: StateDict = {}
        with self._serial_lock():
            for name, default in self._child._defaults.items():
                leaf = getattr(self, name).clone()
                leaf[ids] = default
                new[name] = leaf
            self._set_states(new)
        self._computed = None
        self._forward_cache = None
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "reset_calls")

    def __getstate__(self) -> dict:
        # a snapshot (clone, pickle) is taken between two updates, never in
        # the middle of one; the lock itself stays with the live instance.
        # The child is copied under the lock: an update binds its states to
        # the vmap's batched tensors, and a copy made after the lock is
        # released would read them. Spilled tenants fault back first; the
        # spiller and the durability pins stay with the live instance
        hooks = self.__dict__.get("_durability_hooks")
        if hooks is not None:
            hooks.before_snapshot()
        with self._serial_lock():
            state = super().__getstate__()
            state["_child"] = self._child.clone()
        for k in ("_ingest_lock", "_durability_hooks", "_durability_traffic_pin", "_plan"):
            state.pop(k, None)
        return state

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
        self._traffic = _TenantTraffic(self.num_tenants)

    def _serial_lock(self) -> "threading.RLock":
        """Stateful-update serialization (see :meth:`KeyedMetric._serial_lock`)."""
        return _serial_lock(self)

    @property
    def telemetry_key(self) -> str:
        """Per-instance telemetry key (see :attr:`Metric.telemetry_key`)."""
        key = self.__dict__.get("_telemetry_key")
        if key is None:
            key = TELEMETRY.register(self)
            self._telemetry_key = key
        return key

    # ------------------------------------------------------------------
    # build: layout -> stacked bundles
    # ------------------------------------------------------------------

    def build(self, *sample_batch: Any, **kwargs: Any) -> Dict[str, list]:
        """Group the members (equal shared-update key and state layout) and
        allocate one stacked state bundle per layout entry. Called at the
        first ``update``; idempotent afterwards. The grouping reads no batch,
        so ``sample_batch`` is optional. Returns ``{owner: [member names]}``
        for the multi-member groups formed."""
        with self._serial_lock():  # two first updates on two threads build once
            if self._keyed is not None:
                return {o: list(ns) for o, ns in self._layout if len(ns) > 1}
            coll = self._collection
            coll._note_compute_groups()
            layout = coll._group_layout()
            keyed = OrderedDict(
                (owner, KeyedMetric(coll[owner], self.num_tenants, validate_ids=False, capacity=self._capacity,
                                    device=self.device))
                for owner, _ in layout
            )
            self._layout, self._keyed = layout, keyed
        groups = {o: list(ns) for o, ns in self._layout if len(ns) > 1}
        if TELEMETRY.enabled:
            TELEMETRY.set_info(
                self.telemetry_key,
                "keyed",
                {"tenants": self.num_tenants, "state_bundles": len(self._keyed), "members": len(coll), "groups": groups},
            )
        if EVENTS.enabled:
            EVENTS.record(
                "compile",
                self.telemetry_key,
                path="keyed_build",
                tenants=self.num_tenants,
                state_bundles=len(self._keyed),
                members=len(coll),
                groups=list(groups.values()),
            )
        # the stacked bundles now exist: re-note the memory ledger
        LEDGER.note(self)
        return groups

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

    def _scatter_all(
        self, state: Dict[str, StateDict], ids: Tensor, *args: Any, **kwargs: Any
    ) -> Tuple[Dict[str, StateDict], Tuple[Tensor, Tensor]]:
        """Every bundle advanced by one batch (each member's kwargs filtered),
        and the invalid-id count and per-tenant row counts (the pure program
        of the compiled update, too): every bundle's checks and row states
        first, then ONE merge launch over the int32/float32 leaves of all of
        them (:func:`_scatter_bundles`)."""
        bundles = []
        for owner, keyed in self._keyed.items():
            fkw = self._collection[owner]._filter_kwargs(**kwargs)
            bundles.append((keyed, state[owner], keyed._bundle_rows(args, fkw)))
        with span("scatter"):
            new, invalid, counts = _scatter_bundles(bundles, ids, self._capacity, self.device)
        return dict(zip(self._keyed, new)), (invalid, counts)

    # -- the compiled update ------------------------------------------------------

    #: the compiled update: off until ``warmup``
    _compiled = False
    _donate = True

    def _scan_update_many(self, state: Dict[str, StateDict], stacked: Tuple, stacked_kwargs: Dict
                          ) -> Tuple[Dict[str, StateDict], Tuple[Tensor, Tensor]]:
        """K updates of every bundle unrolled into one program
        (``multitenant.py:1380``); invalid counts and row counts summed."""
        totals: List[Tensor] = []

        def step(s: Dict[str, StateDict], ids: Tensor, *args: Any, **kwargs: Any) -> Dict[str, StateDict]:
            new, (invalid, counts) = self._scatter_all(s, ids, *args, **kwargs)
            totals[:] = [invalid, counts] if not totals else [totals[0] + invalid, totals[1] + counts]
            return new

        return _unrolled(step, state, stacked, stacked_kwargs), (totals[0], totals[1])

    def _pool(self) -> GraphPool:
        pool = self.__dict__.get("_graph_pool")
        if pool is None:
            pool = self.__dict__["_graph_pool"] = GraphPool()
        return pool

    def _dispatch_refs(self, t: Tensor) -> int:
        """References to ``t`` held by every compiled dispatch of this
        collection and of its keyed bundles."""
        mine = (self.__dict__.get(n) for n in _MTC_DISPATCHES)
        return sum(d.refs(t) for d in mine if d is not None) + sum(km._dispatch_refs(t) for km in self._keyed.values())

    def _dispatch(self, name: str, program: Any, donate: bool) -> CompiledDispatch:
        fn = self.__dict__.get(name)
        if fn is None:
            fn = CompiledDispatch(program, donate_state=donate, pool=self._pool(), owner_refs=self._dispatch_refs)
            self.__dict__[name] = fn
        return fn

    def _donation_safe_state(self, state: Dict[str, StateDict]) -> Tuple[Dict[str, StateDict], bool]:
        """Whether the stacked bundles may be written in place: no leaf held
        outside its keyed bundle (see :meth:`Metric._donation_safe_state`)."""
        mine = tuple(self.__dict__.get(n) for n in _MTC_DISPATCHES)
        for owner, km in self._keyed.items():
            name = _aliased_leaf(state[owner], mine + km._dispatches())
            if name is not None:
                km._note_alias_fallback(name)
                return state, False
        return state, True

    def _dispatch_compiled(self, name: str, program: Any, args: Tuple, kwargs: Dict, path: str,
                           hook_ids: Any = None) -> Tuple[Any, CompiledDispatch]:
        """One compiled dispatch over every bundle under the serial lock:
        ``((invalid, counts), fn)``; ``path`` names its profiler bracket and
        ``hook_ids`` are the ids the durability hooks see."""
        keyed = self._keyed
        hooks = self.__dict__.get("_durability_hooks")
        with self._serial_lock():
            if hooks is not None:
                hooks.before_update(hook_ids)
            state = {owner: km._get_states() for owner, km in keyed.items()}
            donatable = False
            if self._donate:
                state, donatable = self._donation_safe_state(state)
            fn = self._dispatch(name if donatable else f"{name}_copy", program, donatable)
            prof = PROFILER.begin(path, self.device)
            new_state, extra = fn(state, *args, **kwargs)
            if prof is not None:
                PROFILER.finish(prof, self.telemetry_key, fn)
            for owner, km in keyed.items():
                km._set_states(new_state[owner])
                km._update_called = True
                km._computed = None
            if hooks is not None:
                hooks.after_update(hook_ids)
        return extra, fn

    def _after_dispatch(self, invalid: Tensor, counts: Tensor) -> None:
        if _ledger_fed(self):
            self._traffic.note(counts)
        TELEMETRY.add_device(self.telemetry_key, "invalid_tenant_ids", invalid)

    def warmup(self, tenant_ids: Any, *sample_batch: Any, **kwargs: Any) -> Dict[str, Any]:
        """Build the bundles if needed and capture the compiled update for
        this batch's signature (``multitenant.py:1454``); ``update`` then
        replays it. The state does not change."""
        if self._keyed is None:
            self.build()
        self._compiled = True
        ids = self._canonical_ids(tenant_ids)
        sample_batch = tuple(_unstage(a) for a in sample_batch)
        kwargs = {k: _unstage(v) for k, v in kwargs.items()}
        self._collection._check_input_device(sample_batch, kwargs)
        fn = self._dispatch("_keyed_update_fn", self._scatter_all, self._donate)
        start = time.perf_counter()
        with self._serial_lock():
            state = {owner: km._get_states() for owner, km in self._keyed.items()}
            fresh = fn.warm(state, ids, *sample_batch, **kwargs)
        return _warmup_report(
            self, fn, fresh, start, arg_signature(ids, *sample_batch, **kwargs), "MultiTenantCollection",
            {owner: km.state_memory_report() for owner, km in self._keyed.items()}, program="update",
            tenants=self.num_tenants, members=len(self._collection), state_bundles=len(self._keyed),
        )

    def update_many(self, tenant_ids: Any, *stacked: Any, **stacked_kwargs: Any) -> None:
        """K stacked cohorts through every bundle in ONE compiled dispatch
        (``multitenant.py:1405``): ``tenant_ids`` is ``(K, B)``, every tensor
        argument has a matching leading K."""
        if self._keyed is None:
            self.build()
        ids = _stacked_ids(self, tenant_ids)
        stacked = tuple(_unstage(a) for a in stacked)
        stacked_kwargs = {k: _unstage(v) for k, v in stacked_kwargs.items()}
        self._collection._check_input_device(stacked, stacked_kwargs)
        k = _microbatch_len((ids,) + stacked, stacked_kwargs)
        if self.validate_ids:
            next(iter(self._keyed.values()))._validate_ids_eager(ids.reshape(-1))
        start = time.perf_counter() if (TELEMETRY.enabled or EVENTS.enabled) else None
        (invalid, counts), fn = self._dispatch_compiled(
            "_update_many_fn", self._scan_update_many, ((ids,) + stacked, stacked_kwargs), {}, "update_many",
            hook_ids=ids.reshape(-1),
        )
        self._after_dispatch(invalid, counts)
        if start is not None:
            dur = time.perf_counter() - start
            key = self.telemetry_key
            if TELEMETRY.enabled:
                TELEMETRY.inc(key, "update_many_calls")
                TELEMETRY.inc(key, "update_many_batches", k)
                observe_dispatch(dur, "update_many")
                _note_compiled_dispatch(self, fn, (ids,) + stacked, stacked_kwargs, counter="update_many_dispatches")
            EVENTS.record(
                "update", key, dur_s=dur, t_start=start, path="scan_microbatch", batches=k,
                tenants=self.num_tenants, state_bundles=len(self._keyed),
                compiled_this_call=bool(fn.last_compiled), donated=fn.donate_state,
            )

    def _canonical_ids(self, tenant_ids: Any) -> Tensor:
        return next(iter(self._require_built().values()))._canonical_ids(tenant_ids)

    def update(self, tenant_ids: Any, *args: Any, **kwargs: Any) -> None:
        """Advance EVERY member's stacked state with one mixed event batch:
        grouped members share a bundle, so the keyed updates per batch number
        the bundles, not the members. Ids validate once, up front."""
        if self._keyed is None:
            self.build()
        keyed = self._keyed
        with span("keyed.update", bundles=len(keyed), path="compiled" if self._compiled else "eager") as request:
            host_ids = tenant_ids if getattr(tenant_ids, "device_tensor", None) is not None else None
            args = tuple(_unstage(a) for a in args)
            kwargs = {k: _unstage(v) for k, v in kwargs.items()}
            self._collection._check_input_device(args, kwargs)
            ids = self._canonical_ids(tenant_ids)
            request.note(rows=int(ids.shape[0]))
            if self.validate_ids:
                next(iter(keyed.values()))._validate_ids_eager(ids if host_ids is None else host_ids)
            start = time.perf_counter() if (TELEMETRY.enabled or EVENTS.enabled) else None
            if self._compiled:
                (invalid, counts), fn = self._dispatch_compiled(
                    "_keyed_update_fn", self._scatter_all, (ids,) + args, kwargs, "keyed_scatter",
                    hook_ids=ids if host_ids is None else host_ids,
                )
                self._after_dispatch(invalid, counts)
                if TELEMETRY.enabled:
                    TELEMETRY.inc(self.telemetry_key, "update_calls")
                    skipped = sum(len(ns) - 1 for _, ns in self._layout)
                    if skipped:
                        TELEMETRY.inc(self.telemetry_key, "update_dedup_skipped", skipped)
                _note_keyed_compiled(self, fn, start, (ids, *args), kwargs, members=len(self._collection),
                                     state_bundles=len(keyed))
                return
            hooks = self.__dict__.get("_durability_hooks")
            hook_ids = ids if host_ids is None else host_ids
            with self._serial_lock():
                if hooks is not None:
                    hooks.before_update(hook_ids)
                state = {owner: km._get_states() for owner, km in keyed.items()}
                prof = PROFILER.begin("keyed_scatter", self.device)
                new_state, (invalid, counts) = self._scatter_all(state, ids, *args, **kwargs)
                if prof is not None:
                    PROFILER.finish(prof, self.telemetry_key)
                for owner, km in keyed.items():
                    km._set_states(new_state[owner])
                    km._update_called = True
                    km._computed = None
                if hooks is not None:
                    hooks.after_update(hook_ids)
            TELEMETRY.add_device(self.telemetry_key, "invalid_tenant_ids", invalid)
            if _ledger_fed(self):
                self._traffic.note(counts)
            if start is not None:
                if TELEMETRY.enabled:
                    TELEMETRY.inc(self.telemetry_key, "update_calls")
                    skipped = sum(len(ns) - 1 for _, ns in self._layout)
                    if skipped:
                        TELEMETRY.inc(self.telemetry_key, "update_dedup_skipped", skipped)
                _note_keyed_update(
                    self, start, int(ids.shape[0]), members=len(self._collection), state_bundles=len(state)
                )

    # ------------------------------------------------------------------
    # compute fan-out + rollups
    # ------------------------------------------------------------------

    def _member_values(self, name: str, state: StateDict) -> Any:
        member = self._collection[name]
        member._restore_derived(state)
        return vmap_compute(member)(state)

    def compute(self) -> Dict[str, Any]:
        """``{member name: per-tenant values}`` — each bundle syncs once
        (its stacked leaves in one descriptor round and one payload round,
        whatever the number of tenants) and fans out to every member's own
        compute, vmapped over the tenant axis."""
        hooks = self.__dict__.get("_durability_hooks")
        if hooks is not None:
            hooks.before_read()
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
        hooks = self.__dict__.get("_durability_hooks")
        if hooks is not None:
            hooks.before_read()
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
        """Reset every bundle — all tenants, or only ``tenant_ids`` — and
        their traffic."""
        if self._keyed is None:
            return
        for km in self._keyed.values():
            km.reset(tenant_ids)
        self._traffic.clear(None if tenant_ids is None else self._canonical_ids(tenant_ids))

    def tenant_report(self, top_k: int = 10) -> Dict[str, Any]:
        """Per-tenant drill-down for the whole collection
        (``multitenant.py:1646``): one ledger, since every member sees the
        same routed rows; see :meth:`KeyedMetric.tenant_report`."""
        invalid = TELEMETRY.counter(self.telemetry_key, "invalid_tenant_ids")
        report = self._traffic.report(top_k, invalid)
        report["metric"] = "MultiTenantCollection"
        report["members"] = len(self._collection)
        report["state_bundles"] = len(self._keyed) if self._keyed is not None else 0
        _publish_tenant_report(self.telemetry_key, report)
        return report

    # ------------------------------------------------------------------
    # elastic tenant capacity
    # ------------------------------------------------------------------

    def grow(self, num_tenants: int) -> int:
        """Grow every bundle's logical tenant axis to ``num_tenants``
        (``multitenant.py:1603``; see :meth:`KeyedMetric.grow`). Returns the
        new physical capacity."""
        target = int(num_tenants)
        if target <= self.num_tenants:
            return self._capacity
        with self._serial_lock():
            for km in (self._keyed or {}).values():
                km.grow(target)
            self.num_tenants = target
            self._capacity = max(self._capacity, _pow2_at_least(target))
            self._traffic.resize(target)
            hooks = self.__dict__.get("_durability_hooks")
            if hooks is not None:
                hooks.on_resize(target)
        LEDGER.note(self)
        return self._capacity

    def compact(self, num_tenants: Optional[int] = None) -> int:
        """Compact every bundle's tenant axis (``multitenant.py:1621``; see
        :meth:`KeyedMetric.compact`); the default target is the highest tenant
        that ever received a row, +1. Returns the new physical capacity."""
        if num_tenants is None:
            rows, _ = self._traffic.arrays()
            active = np.nonzero(rows)[0] if rows is not None else np.array([], np.int64)
            num_tenants = int(active[-1]) + 1 if active.size else 1
        target = int(num_tenants)
        if target > self.num_tenants:
            raise ValueError(
                f"compact target ({target}) exceeds the current tenant count"
                f" ({self.num_tenants}); use grow() to add tenants"
            )
        with self._serial_lock():
            for km in (self._keyed or {}).values():
                km.compact(target)
            self.num_tenants = target
            self._capacity = _pow2_at_least(target)
            self._traffic.resize(target)
            hooks = self.__dict__.get("_durability_hooks")
            if hooks is not None:
                hooks.on_resize(target)
        LEDGER.note(self)
        return self._capacity

    # ------------------------------------------------------------------
    # container / misc protocol
    # ------------------------------------------------------------------

    def keys(self, keep_base: bool = False) -> Any:
        return self._collection.keys(keep_base=keep_base)

    def __getitem__(self, key: str) -> Metric:
        return self._collection[key]

    def __len__(self) -> int:
        return len(self._collection)

    def __getstate__(self) -> dict:
        # a copy registers a telemetry key of its own; the lock, the spiller
        # and the durability pins stay here (spilled tenants fault back
        # first); captured graphs never pickle nor copy
        hooks = self.__dict__.get("_durability_hooks")
        if hooks is not None:
            hooks.before_snapshot()
        with self._serial_lock():
            drop = ("_telemetry_key", "_ingest_lock", "_graph_pool", "_durability_hooks", "_durability_traffic_pin",
                    *_MTC_DISPATCHES)
            state = {k: v for k, v in self.__dict__.items() if k not in drop}
            if self._keyed is not None:
                # each bundle's child copied while no update binds it (see
                # KeyedMetric.__getstate__)
                state["_keyed"] = OrderedDict((owner, copy.copy(km)) for owner, km in self._keyed.items())
            return state

    def __repr__(self) -> str:
        return (
            f"MultiTenantCollection({self._collection!r}, num_tenants={self.num_tenants})"
        )
