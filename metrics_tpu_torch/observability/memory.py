"""Live-buffer memory ledger: device-byte accounting for registered state.

Counterpart of ``metrics_tpu/observability/memory.py`` (a copy: the JAX
module imports no JAX). Every metric, collection, and keyed wrapper owns a
bundle of tensors on its device — its registered state. The ledger tracks
the bytes of each tracked owner **from tensor metadata only**
(``state_memory_report`` sums ``numel * element_size`` per leaf — the
state's logical bytes, exact, and never a device sync; the caching
allocator rounds each block up to 512 bytes, so
``torch.cuda.memory_allocated`` is a check, not the source), and is
re-noted at the seams that already invalidate compiled programs, because
those are the only places the byte total can change:

* ``MetricCollection.add_metrics`` (new bundles appear),
* ``MultiTenantCollection.build`` (the stacked bundles are allocated),
* ``KeyedMetric.grow``/``compact`` and ``MultiTenantCollection.grow``/
  ``compact`` (the tenant axis changes capacity),
* a checkpoint ``restore`` (whole bundles are replaced),

and the ``TenantSpiller``'s evict and fault-back call
:meth:`MemoryLedger.note_spilled` (the host-spilled byte gauge; the device
bytes stay as they are, since rows reset in place).

On top of the per-owner gauge the ledger keeps an incremental
``tracked_bytes`` total with high-water tracking, a bounded sample ring
(the Perfetto memory counter track reads it), and **watermark
callbacks**: :func:`on_pressure` registers a callback fired once when
``tracked_bytes`` crosses ``high``, re-armed when it falls below ``low``
(hysteresis, so a total oscillating at the watermark doesn't storm the
subscriber). In the JAX package the ``TenantSpiller`` subscribes to turn
byte pressure into evictions; here any caller may subscribe.

The conservation law — the incremental total equals the sum of freshly
recomputed live bundle bytes — is checked by :func:`memory_report`
(``conservation_ok``) and asserted byte-exact in the tests. Nothing here is armed by default: ``note()`` on an untracked owner
is one dict membership probe, and :func:`summary` returns ``{}`` until
the first ``track()``.
"""
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "LEDGER",
    "MemoryLedger",
    "PressureHandle",
    "bundle_bytes",
    "memory_report",
    "on_pressure",
]

#: samples kept for the Perfetto memory counter track
_SAMPLE_RING = 4096


def _owner_bytes(owner: Any) -> int:
    """Device bytes of an owner's registered state, from tensor metadata."""
    report = getattr(owner, "state_memory_report", None)
    if report is not None:
        try:
            return int(report()["total_bytes"])
        except Exception:
            pass
    # MultiTenantCollection: sum its built KeyedMetric bundles
    built = getattr(owner, "_require_built", None)
    if built is not None:
        try:
            return sum(_owner_bytes(m) for m in built().values())
        except Exception:
            return 0
    # Last resort: sum the raw state bundles
    from metrics_tpu_torch.observability.cost import pytree_nbytes

    states = getattr(owner, "_get_states", None)
    if states is None:
        return 0
    try:
        return int(pytree_nbytes(states()))
    except Exception:
        return 0


def _owner_key(owner: Any) -> str:
    key = getattr(owner, "telemetry_key", None)
    if key:
        return str(key)
    return f"{type(owner).__name__}@{id(owner):#x}"


class PressureHandle:
    """Cancellation handle for a watermark subscription."""

    def __init__(self, ledger: "MemoryLedger", token: int) -> None:
        self._ledger = ledger
        self._token = token

    def cancel(self) -> None:
        self._ledger._cancel_pressure(self._token)


class MemoryLedger:
    """Process-global device-byte accountant (:data:`LEDGER`).

    Owners are held by weakref; a collected owner's bytes leave the total
    via its finalizer, so the ledger never pins state alive. All writes
    to the incremental total happen under one lock; watermark callbacks
    fire *outside* it (a subscriber that evicts takes the owner's serial
    lock — holding the ledger lock across that would invert against the
    seam noters).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: id(owner) -> entry dict {ref, key, device_bytes, spilled_bytes, updates}
        self._entries: Dict[int, Dict[str, Any]] = {}
        self._tracked = 0
        self._high_water = 0
        self._spilled = 0
        self._updates = 0
        self._samples: deque = deque(maxlen=_SAMPLE_RING)
        self._touched = False
        #: token -> {callback, high, low, armed, fired}
        self._watermarks: Dict[int, Dict[str, Any]] = {}
        self._next_token = 1
        self._pressure_events = 0

    # -- tracking ------------------------------------------------------------

    def track(self, owner: Any) -> int:
        """Start (or refresh) accounting for ``owner``'s state bundles;
        returns its current device bytes. Idempotent."""
        oid = id(owner)
        nbytes = _owner_bytes(owner)
        fire: List[Callable[[int], None]] = []
        with self._lock:
            self._touched = True
            entry = self._entries.get(oid)
            if entry is None:
                ref = weakref.ref(owner, lambda _r, _oid=oid: self._evict_entry(_oid))
                entry = {
                    "ref": ref,
                    "key": _owner_key(owner),
                    "device_bytes": 0,
                    "spilled_bytes": 0,
                    "updates": 0,
                }
                self._entries[oid] = entry
            self._tracked += nbytes - entry["device_bytes"]
            entry["device_bytes"] = nbytes
            entry["updates"] += 1
            self._updates += 1
            self._note_total_locked(fire)
        for cb in fire:
            self._fire(cb)
        return nbytes

    def untrack(self, owner: Any) -> None:
        self._evict_entry(id(owner))

    def _evict_entry(self, oid: int) -> None:
        with self._lock:
            entry = self._entries.pop(oid, None)
            if entry is not None:
                self._tracked -= entry["device_bytes"]
                self._spilled -= entry["spilled_bytes"]

    # -- the seam noter ------------------------------------------------------

    def note(self, owner: Any) -> None:
        """Re-account ``owner`` after a seam that can change its bytes.

        Untracked owners cost one dict probe — the seams call this
        unconditionally. Watermark callbacks fire outside the lock."""
        oid = id(owner)
        if oid not in self._entries:
            return
        nbytes = _owner_bytes(owner)
        fire: List[Callable[[int], None]] = []
        with self._lock:
            entry = self._entries.get(oid)
            if entry is None:
                return
            self._tracked += nbytes - entry["device_bytes"]
            entry["device_bytes"] = nbytes
            entry["updates"] += 1
            self._updates += 1
            self._note_total_locked(fire)
        for cb in fire:
            self._fire(cb)

    def note_spilled(self, owner: Any, spilled_bytes: int) -> None:
        """Record ``owner``'s host-spilled bytes (evict/fault-back seams).

        Spill to host does not change *device* bytes here — eviction
        writes defaults in place, the device array keeps its shape — so
        this updates the spilled gauge only and never trips watermarks."""
        oid = id(owner)
        if oid not in self._entries:
            return
        with self._lock:
            entry = self._entries.get(oid)
            if entry is None:
                return
            self._spilled += int(spilled_bytes) - entry["spilled_bytes"]
            entry["spilled_bytes"] = int(spilled_bytes)
            entry["updates"] += 1
            self._updates += 1

    def _note_total_locked(self, fire: List[Callable[[int], None]]) -> None:
        """Caller holds the lock: stamp high-water, sample, arm callbacks."""
        tracked = self._tracked
        if tracked > self._high_water:
            self._high_water = tracked
        # perf_counter: the event log's clock, so the Perfetto counter track
        # built from these samples lines up with the event slices
        self._samples.append((time.perf_counter(), tracked))
        for wm in self._watermarks.values():
            if wm["armed"]:
                if tracked >= wm["high"]:
                    wm["armed"] = False
                    wm["fired"] += 1
                    self._pressure_events += 1
                    fire.append(wm["callback"])
            elif tracked < wm["low"]:
                wm["armed"] = True

    def _fire(self, callback: Callable[[int], None]) -> None:
        try:
            callback(self._tracked)
        except Exception:  # pragma: no cover - subscriber bugs stay theirs
            pass

    # -- watermarks ----------------------------------------------------------

    def on_pressure(
        self,
        callback: Callable[[int], None],
        *,
        high: int,
        low: Optional[int] = None,
    ) -> PressureHandle:
        """Fire ``callback(tracked_bytes)`` once when the tracked total
        crosses ``high``; re-arm when it falls below ``low`` (default
        ``high // 2``)."""
        if high <= 0:
            raise ValueError(f"high watermark must be positive, got {high}")
        low = high // 2 if low is None else low
        if not 0 <= low < high:
            raise ValueError(f"low watermark must be in [0, high), got {low} (high={high})")
        with self._lock:
            self._touched = True
            token = self._next_token
            self._next_token += 1
            self._watermarks[token] = {
                "callback": callback,
                "high": int(high),
                "low": int(low),
                "armed": True,
                "fired": 0,
            }
        return PressureHandle(self, token)

    def _cancel_pressure(self, token: int) -> None:
        with self._lock:
            self._watermarks.pop(token, None)

    # -- export --------------------------------------------------------------

    def tracked_bytes(self) -> int:
        return self._tracked

    def high_water_bytes(self) -> int:
        return self._high_water

    def spilled_bytes(self) -> int:
        return self._spilled

    def owner_bytes(self, owner: Any) -> Optional[int]:
        entry = self._entries.get(id(owner))
        return None if entry is None else entry["device_bytes"]

    def samples(self) -> List[Tuple[float, int]]:
        """The bounded (perf_counter_ts, tracked_bytes) ring — the Perfetto
        memory counter track's feed (same clock as the event log)."""
        with self._lock:
            return list(self._samples)

    def report(self) -> Dict[str, Any]:
        """Per-owner bytes plus the conservation check: each live owner is
        *recomputed fresh* from its tensors' metadata and summed against the
        incremental total — a torn or missed seam shows up as
        ``conservation_ok: False``."""
        with self._lock:
            entries = [(oid, dict(e), e["ref"]) for oid, e in self._entries.items()]
            tracked = self._tracked
            high_water = self._high_water
            spilled = self._spilled
            updates = self._updates
            pressure_events = self._pressure_events
            watermarks = [
                {"high": wm["high"], "low": wm["low"],
                 "armed": wm["armed"], "fired": wm["fired"]}
                for wm in self._watermarks.values()
            ]
        owners: Dict[str, Dict[str, Any]] = {}
        recomputed_total = 0
        for _oid, entry, ref in entries:
            owner = ref()
            if owner is None:
                continue
            fresh = _owner_bytes(owner)
            recomputed_total += fresh
            owners[entry["key"]] = {
                "device_bytes": entry["device_bytes"],
                "recomputed_bytes": fresh,
                "spilled_bytes": entry["spilled_bytes"],
                "updates": entry["updates"],
            }
        return {
            "tracked_bytes": tracked,
            "recomputed_bytes": recomputed_total,
            "conservation_ok": tracked == recomputed_total,
            "high_water_bytes": high_water,
            "spilled_bytes": spilled,
            "updates": updates,
            "owners": owners,
            "watermarks": watermarks,
            "pressure_events": pressure_events,
        }

    def summary(self) -> Dict[str, Any]:
        """The ``snapshot()["memory"]`` section: ``{}`` until the first
        ``track()``/``on_pressure()``, flat numeric gauges after (the
        fleet merge sums bytes and maxes the high-water)."""
        with self._lock:
            if not self._touched:
                return {}
            return {
                "owners": len(self._entries),
                "tracked_bytes": self._tracked,
                "high_water_bytes": self._high_water,
                "spilled_bytes": self._spilled,
                "updates": self._updates,
                "pressure_events": self._pressure_events,
                "watermarks": len(self._watermarks),
            }

    # -- lifecycle -----------------------------------------------------------

    def disable(self) -> None:
        """``observability.disable()``: drop pending watermark callbacks —
        a disabled stack must never call back into spill logic."""
        with self._lock:
            self._watermarks.clear()

    def reset(self) -> None:
        """``observability.reset()``: clear counters, samples, high-water
        (re-seeded at the current total), and pending watermark callbacks.
        Tracked owners persist — they are registrations, not counters."""
        with self._lock:
            self._high_water = self._tracked
            self._updates = 0
            self._pressure_events = 0
            self._samples.clear()
            self._watermarks.clear()
            for entry in self._entries.values():
                entry["updates"] = 0
            self._touched = bool(self._entries)


#: the process-global memory ledger
LEDGER = MemoryLedger()


def bundle_bytes(owner: Any) -> int:
    """Current device bytes of ``owner``'s registered state, recomputed
    fresh from tensor metadata (no device sync, no ledger registration)."""
    return _owner_bytes(owner)


def memory_report() -> Dict[str, Any]:
    """Per-owner device bytes, the conservation check, watermark state —
    see :meth:`MemoryLedger.report`."""
    return LEDGER.report()


def on_pressure(
    callback: Callable[[int], None], *, high: int, low: Optional[int] = None
) -> PressureHandle:
    """Subscribe a byte-pressure watermark on the global ledger — see
    :meth:`MemoryLedger.on_pressure`."""
    return LEDGER.on_pressure(callback, high=high, low=low)


def summary() -> Dict[str, Any]:
    """The memory snapshot section (``{}`` until the first tracking)."""
    return LEDGER.summary()
