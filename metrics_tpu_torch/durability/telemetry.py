"""The ``durability.*`` telemetry family: exact accounting for the state
lifecycle plane.

Counterpart of ``metrics_tpu/durability/telemetry.py``, the same host-side
code.

One process-global :class:`DurabilityStats` ledger records every checkpoint
outcome (full / delta saves, bytes written, tenants stamped, restores, bytes
read), every spill decision (evictions, fault-backs, the resident/spilled
occupancy gauges with a high-water mark), and every elastic resize (grows,
compactions). The ledger surfaces in the same three places as the serving
family:

* ``observability.snapshot()["durability"]`` — the JSON view below, ``{}``
  until the durability plane is first touched (processes that never
  checkpoint or spill keep a clean snapshot). Fleet aggregation works day
  one: :data:`~metrics_tpu_torch.observability.aggregate.MERGE_RULES` declares
  counters sum, occupancy gauges sum (fleet totals), the high-water gauge
  maxes.
* the ``metrics_tpu_durability_*`` Prometheus series
  (:func:`~metrics_tpu_torch.observability.export.render_prometheus`).
* fast-path log2 histograms: ``durability_save_seconds`` (one snapshot
  write, labeled ``kind=full|delta``), ``durability_restore_seconds`` (one
  chain restore), and ``durability_faultback_seconds`` (one spill
  fault-back cohort) — mergeable bucket tables like every other family.

Everything here is host-side bookkeeping behind the lock-free
``TELEMETRY.enabled`` gate; the compiled metric programs are untouched.
"""
import threading
import weakref
from typing import Any, Dict

from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.histogram import HISTOGRAMS
from metrics_tpu_torch.observability.registry import TELEMETRY

__all__ = [
    "DURABILITY_STATS",
    "DurabilityStats",
    "note_resize",
    "observe_faultback",
    "observe_restore",
    "observe_save",
    "pin_tenant_traffic",
    "summary",
    "unpin_tenant_traffic",
]

def pin_tenant_traffic(metric: Any) -> None:
    """Hold ``metric``'s per-tenant traffic ledger OPEN (refcounted): while
    at least one pin is held, the keyed wrappers feed the ledger on every
    update even with ``TELEMETRY`` disabled. A durability actor that reads
    the ledger as ground truth — the checkpoint delta dirty set, the
    spiller's staleness stamps — MUST pin it: a ledger frozen by a telemetry
    toggle would silently drop touched tenants from the next delta save and
    stale the eviction signal."""
    d = metric.__dict__
    d["_durability_traffic_pin"] = int(d.get("_durability_traffic_pin", 0)) + 1


def unpin_tenant_traffic(metric: Any) -> None:
    """Release one :func:`pin_tenant_traffic` hold."""
    d = metric.__dict__
    n = int(d.get("_durability_traffic_pin", 0)) - 1
    if n > 0:
        d["_durability_traffic_pin"] = n
    else:
        d.pop("_durability_traffic_pin", None)


#: canonical fast-path histogram series of the durability plane
SAVE_SECONDS = "durability_save_seconds"
RESTORE_SECONDS = "durability_restore_seconds"
FAULTBACK_SECONDS = "durability_faultback_seconds"


def observe_save(seconds: float, kind: str) -> None:
    """One snapshot write's wall time, labeled ``kind=full|delta``."""
    HISTOGRAMS.observe(SAVE_SECONDS, seconds, unit="s", kind=kind)


def observe_restore(seconds: float) -> None:
    """One chain restore's wall time (manifest reads + payload decode +
    placement)."""
    HISTOGRAMS.observe(RESTORE_SECONDS, seconds, unit="s")


def observe_faultback(seconds: float) -> None:
    """One fault-back cohort's wall time (host rows -> device scatter)."""
    HISTOGRAMS.observe(FAULTBACK_SECONDS, seconds, unit="s")


class DurabilityStats:
    """Thread-safe counters for the durability plane (one process-global
    instance, :data:`DURABILITY_STATS`; private instances supported for
    tests). ``touched`` stays False until the first save/evict/resize, so an
    idle process's snapshot omits the section entirely."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._touched = False
        self._spillers: "weakref.WeakSet" = weakref.WeakSet()
        self._counters: Dict[str, int] = {
            "saves": 0,
            "delta_saves": 0,
            "auto_saves": 0,
            "save_errors": 0,
            "restores": 0,
            "restore_errors": 0,
            "bytes_written": 0,
            "bytes_read": 0,
            "tenants_stamped": 0,
            "evictions": 0,
            "fault_backs": 0,
            "grows": 0,
            "compactions": 0,
        }
        self._spilled_high_water = 0

    # -- recording ----------------------------------------------------------

    def register_spiller(self, spiller: Any) -> None:
        with self._lock:
            self._touched = True
            self._spillers.add(spiller)

    def inc(self, counter: str, n: int = 1) -> None:
        if not TELEMETRY.enabled:
            return
        with self._lock:
            self._touched = True
            self._counters[counter] = self._counters.get(counter, 0) + int(n)

    def note_spill_occupancy(self, spilled: int) -> None:
        """Point-in-time spilled-tenant count after an evict/fault-back —
        feeds the high-water mark (the gauges themselves read live spillers
        at snapshot time, so they can never go stale)."""
        if not TELEMETRY.enabled:
            return
        with self._lock:
            self._touched = True
            if spilled > self._spilled_high_water:
                self._spilled_high_water = int(spilled)

    # -- reading ------------------------------------------------------------

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def summary(self) -> Dict[str, Any]:
        """The ``snapshot()["durability"]`` section (``{}`` when untouched)."""
        with self._lock:
            if not self._touched:
                return {}
            spillers = list(self._spillers)
            out: Dict[str, Any] = {
                **dict(self._counters),
                "spillers": len(spillers),
                "spilled_tenants": 0,
                "resident_tenants": 0,
                "spilled_bytes": 0,
                "spilled_high_water": self._spilled_high_water,
            }
        # occupancy is read OUTSIDE the stats lock: a spiller mutates under
        # its metric's ingest lock, and nesting the other way here would be
        # an ABBA deadlock (the serving ledger's discipline)
        for sp in spillers:
            try:
                occ = sp.occupancy()
            except Exception:  # pragma: no cover - a detaching spiller
                continue
            out["spilled_tenants"] += occ["spilled"]
            out["resident_tenants"] += occ["resident_active"]
            out["spilled_bytes"] += occ["spilled_bytes"]
        return out

    def reset(self) -> None:
        """Zero every counter (live spillers stay registered — their
        occupancy keeps reporting)."""
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0
            self._spilled_high_water = 0


#: the process-global durability ledger
DURABILITY_STATS = DurabilityStats()


def summary() -> Dict[str, Any]:
    """Module-level accessor ``observability.snapshot()`` reads."""
    return DURABILITY_STATS.summary()


def note_resize(key: str, kind: str, num_tenants: int, capacity: int) -> None:
    """One elastic resize (``kind`` = ``grow``/``compact``) — counter + a
    ``durability`` timeline event carrying the new logical/physical sizes."""
    DURABILITY_STATS.inc("grows" if kind == "grow" else "compactions")
    if TELEMETRY.enabled:
        TELEMETRY.inc(key, f"capacity_{kind}s")
    if EVENTS.enabled:
        EVENTS.record(
            "durability",
            key,
            path=kind,
            num_tenants=int(num_tenants),
            capacity=int(capacity),
        )
