"""Cold-tenant spill: LRU-evict idle tenants' rows to host memory.

Counterpart of ``metrics_tpu/durability/spill.py`` (``TenantSpiller``
``:68``, ``maybe_evict`` ``:344``, ``evict`` ``:404``, ``fault_back``
``:422``, ``_pad_pow2`` ``:57``). On the card an eviction gathers the
cohort's rows of every stacked leaf with ``index_select``, packs them into
one matrix and copies it to pinned host memory behind an event, then resets
the rows to the defaults with ``index_copy_``; a fault-back copies the saved
rows from pinned memory (``non_blocking``) and writes them back with
``index_copy_``. Both write the stacked leaves in place, so a compiled keyed
update's held graph keeps updating the live state. The hooks see the ids
on the host: a staged cohort's host view as it is, an id tensor read to the
host once per update while a spiller is attached.

A weeks-long multi-tenant service accumulates state for every tenant that
EVER appeared; device HBM pays for all of them forever even though traffic
is heavily skewed. :class:`TenantSpiller` bounds the device-resident
working set: tenants idle longest (the traffic ledger's
``last_seen`` is the signal; the spiller keeps its own stamp as a fallback
so eviction works with telemetry disabled) are **evicted** — their rows of
every stacked leaf copy to host numpy and the device rows reset to the
child defaults — and **fault back transparently**:

* an ``update``/``update_many`` naming a spilled tenant faults its rows
  back BEFORE the dispatch (under the metric's ingest lock), so every
  routable reduction accumulates exactly — no merge arithmetic, no drift;
* a ``compute()``/rollup/clone/checkpoint faults back every spilled tenant
  first (``before_read``/``before_snapshot``), so reads are bit-identical
  to a never-evicted metric.

The spiller installs itself as the metric's durability hooks
(``metric._durability_hooks``) — the wrappers call ``before_update``/
``after_update``/``before_read``/``before_snapshot``/``on_resize`` from
their stateful paths, and the checkpoint plane calls ``on_restore`` after
installing a snapshot (spilled host rows predate the restored state and
must be dropped, never faulted back); the pure ``apply_update`` path is
untouched. Eviction/fault-back scatters pad their tenant cohorts to
power-of-two buckets (ids repeated — an idempotent row write), so their
shapes stay log2-bounded like the serving queue's ``pad_to_bucket``.

**Conservation law** (checked by :meth:`report`, pinned by the spill soak):
``resident_active + spilled == active_total`` — every tenant that ever
received a row is either device-resident or host-spilled, never both,
never neither — and the serving ledger's
``submitted − shed == dispatched == rows_routed`` invariant is untouched
because fault-back precedes every dispatch.
"""
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.durability.telemetry import (
    DURABILITY_STATS,
    observe_faultback,
    pin_tenant_traffic,
    unpin_tenant_traffic,
)
from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.utilities.data import to_host

__all__ = ["TenantSpiller"]


def _pad_pow2(ids: np.ndarray) -> np.ndarray:
    """Pad a tenant cohort to the next power-of-two length by repeating the
    last id — duplicate scatter-writes of the same row value are
    idempotent, and the padded shapes bound the executable cache."""
    n = len(ids)
    bucket = 1 << max(0, n - 1).bit_length()
    if bucket == n:
        return ids
    return np.concatenate([ids, np.full(bucket - n, ids[-1], ids.dtype)])


def _host_ids(ids: Any) -> np.ndarray:
    """The hooks' ids on the host: a host array (a staged cohort's view) as
    it is, a tensor read once."""
    if isinstance(ids, torch.Tensor):
        return to_host(ids.detach(), numpy=True).reshape(-1)
    return np.asarray(ids).reshape(-1)


def _row_columns(leaves: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], torch.dtype, int]]:
    """``(name, row shape, dtype, row bytes)`` of each stacked leaf."""
    return [(name, tuple(leaf.shape[1:]), leaf.dtype, leaf[:1].numel() * leaf.element_size())
            for name, leaf in leaves.items()]


def _to_host(src: torch.Tensor) -> np.ndarray:
    """``src`` copied to the host: on the card into pinned memory behind an
    event (no synchronizing call of the stream)."""
    if not src.is_cuda:
        return src.numpy()
    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    host.copy_(src, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(src.device))
    done.synchronize()
    return host.numpy()


def _to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """``host`` copied to ``device``: on the card from pinned memory,
    ``non_blocking`` (the pinned buffer is kept until the copy is done)."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return src
    return src.pin_memory().to(device, non_blocking=True)


class TenantSpiller:
    """Bound a keyed metric's device-resident tenant rows.

    Args:
        metric: a :class:`~metrics_tpu_torch.wrappers.KeyedMetric` or
            :class:`~metrics_tpu_torch.wrappers.MultiTenantCollection` (a
            collection spills the same tenant's rows across EVERY state
            bundle together — a tenant is resident or spilled as a unit).
        resident_cap: target bound on device-resident ACTIVE tenants;
            ``maybe_evict`` (run automatically after every update when
            ``auto=True``) evicts the coldest active tenants down to it.
        min_idle_s: never evict a tenant updated more recently than this
            (hot tenants stay resident even over the cap).
        auto: evict automatically after each update dispatch.
        pressure_high: optional BYTE watermark — when the memory ledger's
            tracked device total crosses it, the spiller evicts the coldest
            ``pressure_fraction`` of resident active tenants (staleness
            still orders the victims; byte pressure triggers the pass).
            Arms a :func:`metrics_tpu_torch.observability.memory.on_pressure`
            subscription; re-arms below ``pressure_low``.
        pressure_low: re-arm watermark (default ``pressure_high // 2``).
        pressure_fraction: share of resident active tenants a pressure
            pass evicts (at least one, never the last resident).
    """

    def __init__(
        self,
        metric: Any,
        *,
        resident_cap: int,
        min_idle_s: float = 0.0,
        auto: bool = True,
        pressure_high: Optional[int] = None,
        pressure_low: Optional[int] = None,
        pressure_fraction: float = 0.5,
    ) -> None:
        if int(resident_cap) < 1:
            raise ValueError(f"resident_cap must be >= 1, got {resident_cap}")
        existing = metric.__dict__.get("_durability_hooks")
        if existing is not None:
            raise ValueError(
                f"{type(metric).__name__} already has durability hooks"
                f" ({type(existing).__name__}); detach() the old spiller first"
            )
        self._metric = metric
        self.resident_cap = int(resident_cap)
        self.min_idle_s = float(min_idle_s)
        self.auto = bool(auto)
        n = int(metric.num_tenants)
        #: tenant -> {bundle -> {leaf -> host row}} (the spilled rows)
        self._spilled: Dict[int, Dict[str, Dict[str, np.ndarray]]] = {}
        #: own touch stamps/active mask: correct even with telemetry off
        self._last_touch = np.full(n, -np.inf)
        self._touched = np.zeros(n, dtype=bool)
        # seed from the traffic ledger so tenants active BEFORE the
        # spiller attached are eviction candidates from the first pass
        traffic = getattr(metric, "_traffic", None)
        if traffic is not None:
            rows, last_seen = traffic.arrays()
            if rows is not None:
                k = min(n, len(rows))
                self._touched[:k] = rows[:k] > 0
                seen = last_seen[:k] - time.time() + time.monotonic()
                self._last_touch[:k] = np.where(np.isnan(last_seen[:k]), -np.inf, seen)
        self._spilled_bytes = 0
        self.telemetry_key = TELEMETRY.register(self)
        # the eviction signal prefers the traffic ledger's staleness stamps,
        # so hold the ledger open: a telemetry toggle must not freeze it
        # (frozen stamps would evict hot tenants / keep cold ones resident)
        self._traffic_unpin = None
        if traffic is not None:
            pin_tenant_traffic(metric)
            self._traffic_unpin = weakref.finalize(
                self, unpin_tenant_traffic, metric
            )
        metric.__dict__["_durability_hooks"] = self
        DURABILITY_STATS.register_spiller(self)
        # memory-ledger integration: the wrapped metric's device bytes are
        # tracked from attach, and an optional byte watermark turns ledger
        # pressure into eviction passes
        from metrics_tpu_torch.observability.memory import LEDGER

        LEDGER.track(metric)
        self.pressure_evictions = 0
        self._pressure_handle = None
        if pressure_high is not None:
            if not 0.0 < float(pressure_fraction) <= 1.0:
                raise ValueError(
                    f"pressure_fraction must be in (0, 1], got {pressure_fraction}"
                )
            self._pressure_fraction = float(pressure_fraction)
            self._pressure_handle = LEDGER.on_pressure(
                self._on_pressure, high=int(pressure_high), low=pressure_low
            )

    # ------------------------------------------------------------------
    # hook protocol (called by the wrappers' stateful paths)
    # ------------------------------------------------------------------

    def before_update(self, ids: Any) -> None:
        """Fault back any spilled tenant named in this batch (exactness:
        the dispatch must accumulate onto the true rows)."""
        if self._spilled:
            hit = sorted({int(t) for t in np.unique(_host_ids(ids)) if int(t) in self._spilled})
            if hit:
                self._fault_back_ids(hit)

    def after_update(self, ids: Any) -> None:
        now = time.monotonic()
        ids = _host_ids(ids)
        valid = ids[(ids >= 0) & (ids < len(self._last_touch))]
        if valid.size:
            self._last_touch[valid] = now
            self._touched[valid] = True
        if self.auto:
            self.maybe_evict()

    def before_read(self) -> None:
        """Full-residency barrier for reads: every spilled tenant faults
        back so per-tenant values are bit-identical to never-evicted."""
        self.fault_back()

    def before_snapshot(self) -> None:
        """Same barrier for clones/pickles/checkpoints."""
        self.fault_back()

    def on_resize(self, num_tenants: int) -> None:
        n = int(num_tenants)
        old = len(self._last_touch)
        keep = min(old, n)
        last, touched = self._last_touch, self._touched
        self._last_touch = np.full(n, -np.inf)
        self._touched = np.zeros(n, dtype=bool)
        self._last_touch[:keep] = last[:keep]
        self._touched[:keep] = touched[:keep]
        for t in [t for t in self._spilled if t >= n]:
            entry = self._spilled.pop(t)
            self._spilled_bytes -= sum(
                r.nbytes for leaves in entry.values() for r in leaves.values()
            )
        self._note_ledger_spilled()

    def on_restore(self) -> None:
        """Restore invalidation — the checkpoint plane calls this under the
        metric's serial lock right after installing a snapshot. Every
        device row was just replaced, so all spilled host rows predate the
        restore: faulting them back would silently corrupt the restored
        tenants. Drop them and re-seed the activity set from the restored
        traffic ledger (restored tenants are active and immediately
        eviction-eligible — their stamps start at cold)."""
        self._spilled.clear()
        self._spilled_bytes = 0
        self._note_ledger_spilled()
        self._last_touch.fill(-np.inf)
        self._touched.fill(False)
        traffic = getattr(self._metric, "_traffic", None)
        if traffic is not None:
            rows, _ = traffic.arrays()
            if rows is not None:
                k = min(len(self._touched), len(rows))
                self._touched[:k] = rows[:k] > 0

    # ------------------------------------------------------------------
    # the spill mechanics
    # ------------------------------------------------------------------

    def _note_ledger_spilled(self) -> None:
        """Mirror the host-spilled byte gauge into the memory ledger (device
        bytes are untouched by evict/fault-back — rows reset in place — so
        this is a spilled-gauge update, never a watermark trigger)."""
        from metrics_tpu_torch.observability.memory import LEDGER

        LEDGER.note_spilled(self._metric, self._spilled_bytes)

    def _bundles(self) -> Dict[str, Any]:
        m = self._metric
        if hasattr(m, "_require_built"):
            return dict(m._require_built())
        return {"": m}

    def _evict_ids(self, ids: List[int]) -> None:
        ordered = sorted(ids)
        padded = _pad_pow2(np.asarray(ordered, dtype=np.int64))
        bundles = self._bundles()
        device = next(iter(bundles.values())).device
        idx = _to_device(padded, device)
        # every bundle's rows of the cohort in one matrix, one copy to the host
        layout, parts = [], []
        for bundle, owner in bundles.items():
            leaves = owner._get_states()
            for name, shape, dtype, nbytes in _row_columns(leaves):
                layout.append((bundle, name, shape, dtype, nbytes))
                parts.append(leaves[name].index_select(0, idx).reshape(len(padded), -1).view(torch.uint8))
        host = _to_host(torch.cat(parts, dim=1))
        for bundle, owner in bundles.items():
            defaults = owner._child._defaults
            for name in owner._defaults:
                leaf = getattr(owner, name)
                fill = defaults[name].to(leaf.dtype).expand((len(padded),) + tuple(leaf.shape[1:])).contiguous()
                leaf.index_copy_(0, idx, fill)
            owner._computed = None
            owner._forward_cache = None
        offset = 0
        for bundle, name, shape, dtype, nbytes in layout:
            np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
            block = host[:, offset:offset + nbytes]
            offset += nbytes
            for i, t in enumerate(ordered):
                row = block[i].copy().view(np_dtype).reshape(shape)
                self._spilled.setdefault(t, {}).setdefault(bundle, {})[name] = row
                self._spilled_bytes += row.nbytes
        DURABILITY_STATS.inc("evictions", len(ids))
        DURABILITY_STATS.note_spill_occupancy(len(self._spilled))
        self._note_ledger_spilled()
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "evictions", len(ids))
        if EVENTS.enabled:
            EVENTS.record(
                "durability",
                self.telemetry_key,
                path="evict",
                tenants=len(ids),
                spilled=len(self._spilled),
            )

    def _fault_back_ids(self, ids: List[int]) -> None:
        start = time.perf_counter()
        ordered = sorted(ids)
        padded = _pad_pow2(np.asarray(ordered, dtype=np.int64))
        pad_tail = len(padded) - len(ordered)
        bundles = self._bundles()
        device = next(iter(bundles.values())).device
        # every bundle's saved rows in one matrix, one copy to the device
        layout, parts = [], []
        for bundle, owner in bundles.items():
            for name in owner._defaults:
                rows = np.stack(
                    [self._spilled[t][bundle][name] for t in ordered]
                    + [self._spilled[ordered[-1]][bundle][name]] * pad_tail
                )
                raw = np.ascontiguousarray(rows).reshape(len(padded), -1).view(np.uint8)
                layout.append((owner, name, raw.shape[1]))
                parts.append(raw)
        packed = _to_device(np.concatenate(parts, axis=1), device)
        idx = _to_device(padded, device)
        offset = 0
        for owner, name, nbytes in layout:
            leaf = getattr(owner, name)
            rows = packed[:, offset:offset + nbytes].contiguous().view(leaf.dtype)
            leaf.index_copy_(0, idx, rows.reshape((len(padded),) + tuple(leaf.shape[1:])))
            offset += nbytes
            owner._computed = None
            owner._forward_cache = None
        for t in ordered:
            entry = self._spilled.pop(t)
            self._spilled_bytes -= sum(
                r.nbytes for leaves in entry.values() for r in leaves.values()
            )
        dur = time.perf_counter() - start
        DURABILITY_STATS.inc("fault_backs", len(ordered))
        DURABILITY_STATS.note_spill_occupancy(len(self._spilled))
        self._note_ledger_spilled()
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "fault_backs", len(ordered))
            observe_faultback(dur)
        if EVENTS.enabled:
            EVENTS.record(
                "durability",
                self.telemetry_key,
                dur_s=dur,
                t_start=start,
                path="fault_back",
                tenants=len(ordered),
                spilled=len(self._spilled),
            )

    # ------------------------------------------------------------------
    # public control plane
    # ------------------------------------------------------------------

    def _lock(self):
        return self._metric._serial_lock()

    def _stamps(self) -> np.ndarray:
        """Eviction signal: the metric's staleness ledger when it is
        tracking, the spiller's own touch stamps otherwise."""
        traffic = getattr(self._metric, "_traffic", None)
        if traffic is not None:
            rows, last_seen = traffic.arrays()
            if last_seen is not None:
                stamps = np.where(np.isnan(last_seen), -np.inf, last_seen)
                # ledger stamps are wall-clock; shift into the monotonic
                # frame the min_idle_s comparison uses
                return stamps - time.time() + time.monotonic()
        return self._last_touch

    def maybe_evict(self) -> int:
        """Evict the coldest eligible active tenants down to
        ``resident_cap``; returns tenants evicted. Called automatically
        after each update when ``auto=True``."""
        with self._lock():
            active = np.nonzero(self._touched)[0]
            resident = [int(t) for t in active if int(t) not in self._spilled]
            excess = len(resident) - self.resident_cap
            if excess <= 0:
                return 0
            stamps = self._stamps()
            now = time.monotonic()
            eligible = [
                t for t in resident if now - stamps[t] >= self.min_idle_s
            ]
            if not eligible:
                return 0
            eligible.sort(key=lambda t: stamps[t])
            victims = eligible[: min(excess, len(eligible))]
            if victims:
                self._evict_ids(victims)
            return len(victims)

    def _on_pressure(self, tracked_bytes: int) -> None:
        """Ledger watermark callback: byte pressure triggers an eviction
        pass over the coldest ``pressure_fraction`` of resident active
        tenants (``min_idle_s`` still protects hot tenants, and the last
        resident tenant never spills). Fires outside the ledger lock; takes
        the metric's serial lock like every other eviction."""
        import math

        with self._lock():
            active = np.nonzero(self._touched)[0]
            resident = [int(t) for t in active if int(t) not in self._spilled]
            if len(resident) <= 1:
                return
            stamps = self._stamps()
            now = time.monotonic()
            eligible = [t for t in resident if now - stamps[t] >= self.min_idle_s]
            if not eligible:
                return
            eligible.sort(key=lambda t: stamps[t])
            quota = max(1, math.ceil(len(resident) * self._pressure_fraction))
            quota = min(quota, len(resident) - 1, len(eligible))
            victims = eligible[:quota]
            if not victims:
                return
            self._evict_ids(victims)
            self.pressure_evictions += len(victims)
            if TELEMETRY.enabled:
                TELEMETRY.inc(self.telemetry_key, "pressure_evictions", len(victims))
            if EVENTS.enabled:
                EVENTS.record(
                    "durability",
                    self.telemetry_key,
                    path="pressure_evict",
                    tenants=len(victims),
                    tracked_bytes=int(tracked_bytes),
                )

    def evict(self, tenant_ids: Optional[Any] = None) -> int:
        """Evict ``tenant_ids`` (or run one :meth:`maybe_evict` pass);
        already-spilled / never-active ids are skipped. Returns tenants
        evicted."""
        if tenant_ids is None:
            return self.maybe_evict()
        with self._lock():
            ids = [
                int(t)
                for t in np.asarray(tenant_ids).reshape(-1)
                if 0 <= int(t) < len(self._touched)
                and self._touched[int(t)]
                and int(t) not in self._spilled
            ]
            if ids:
                self._evict_ids(ids)
            return len(ids)

    def fault_back(self, tenant_ids: Optional[Any] = None) -> int:
        """Fault spilled tenants back to the device (all of them by
        default). Returns tenants restored."""
        with self._lock():
            if tenant_ids is None:
                ids = list(self._spilled)
            else:
                ids = [
                    int(t)
                    for t in np.asarray(tenant_ids).reshape(-1)
                    if int(t) in self._spilled
                ]
            if ids:
                self._fault_back_ids(ids)
            return len(ids)

    def occupancy(self) -> Dict[str, int]:
        """Point-in-time occupancy (the durability snapshot's gauge feed).
        ``resident_active`` is counted independently of ``spilled`` —
        touched tenants whose ids are NOT in the spill table — so the
        conservation law :meth:`report` checks is falsifiable: a stranded
        or duplicated spill entry (a spilled tenant outside the active set)
        breaks ``resident_active + spilled == active`` instead of hiding in
        derived arithmetic."""
        spilled_map = self._spilled
        active_ids = np.nonzero(self._touched)[0]
        resident_active = sum(1 for t in active_ids if int(t) not in spilled_map)
        return {
            "active": int(active_ids.size),
            "spilled": len(spilled_map),
            "resident_active": int(resident_active),
            "spilled_bytes": int(self._spilled_bytes),
        }

    def report(self) -> Dict[str, Any]:
        """Occupancy + the conservation check:
        ``resident_active + spilled == active`` exactly (both sides counted
        independently — see :meth:`occupancy`), plus the byte view —
        ``resident_bytes`` is the metric's live device footprint recomputed
        from aval metadata, ``spilled_bytes`` the host-side rows."""
        from metrics_tpu_torch.observability.memory import bundle_bytes

        occ = self.occupancy()
        return {
            **occ,
            "resident_bytes": int(bundle_bytes(self._metric)),
            "resident_cap": self.resident_cap,
            "min_idle_s": self.min_idle_s,
            "auto": self.auto,
            "pressure_evictions": int(self.pressure_evictions),
            "conservation_ok": occ["resident_active"] + occ["spilled"] == occ["active"],
            "resident_under_cap": occ["resident_active"] <= self.resident_cap,
        }

    def detach(self) -> None:
        """Fault everything back and uninstall the hooks (the metric
        reverts to plain always-resident behavior)."""
        self.fault_back()
        if self._pressure_handle is not None:
            self._pressure_handle.cancel()
            self._pressure_handle = None
        if self._metric.__dict__.get("_durability_hooks") is self:
            del self._metric.__dict__["_durability_hooks"]
        if self._traffic_unpin is not None:
            self._traffic_unpin()

    def __repr__(self) -> str:
        occ = self.occupancy()
        return (
            f"TenantSpiller({type(self._metric).__name__},"
            f" resident_cap={self.resident_cap}, spilled={occ['spilled']})"
        )
