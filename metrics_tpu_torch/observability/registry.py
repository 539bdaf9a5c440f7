"""Telemetry registry: host-side per-metric counters, timers and sync stats.

Counterpart of ``metrics_tpu/observability/registry.py``. Every
instrumented point of the package (``metric.py`` forward/update/compute/
reset, the collection, the keyed wrappers, ``utilities/distributed.py``'s
gather and packed sync) records into the process-global :data:`TELEMETRY`;
``observability.snapshot()`` reads it back out as one JSON-serializable
dict.

Design constraints, in order:

* **Never wait on the card.** All state is plain Python under a
  ``threading.Lock``; call sites record host-side facts only (counts, host
  clock intervals, shapes). A count that only the card knows (the keyed
  update's invalid tenant ids) is added into a device-side int64
  accumulator (:meth:`TelemetryRegistry.add_device`) and read to the host
  only when :meth:`~TelemetryRegistry.snapshot` or
  :meth:`~TelemetryRegistry.counter` asks, in one read per call.
* **Cheap when enabled, free-ish when disabled.** Call sites gate on the
  lock-free :attr:`TelemetryRegistry.enabled` read before any timing or
  recording work; a disabled registry costs one attribute read per call.
* **Instance-keyed.** Metrics are keyed ``"<ClassName>#<ordinal>"`` so two
  ``Accuracy`` instances in one process stay distinguishable; the registry
  holds only a ``weakref`` to each instance, never a strong reference.
"""
import bisect
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

#: histogram bucket upper bounds (seconds) for wall-time observations;
#: log-spaced from 10 µs to 1 s, with +inf implicit
HISTOGRAM_BUCKETS_S = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0)


class _Histogram:
    """Fixed-bucket wall-time histogram (Prometheus ``le`` semantics)."""

    __slots__ = ("counts", "count", "sum_s")

    def __init__(self) -> None:
        self.counts = [0] * (len(HISTOGRAM_BUCKETS_S) + 1)
        self.count = 0
        self.sum_s = 0.0

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.sum_s += seconds
        # the first bound >= seconds; past the last, the +inf bucket
        self.counts[bisect.bisect_left(HISTOGRAM_BUCKETS_S, seconds)] += 1

    def to_dict(self) -> Dict[str, Any]:
        buckets = {f"le_{bound:g}s": c for bound, c in zip(HISTOGRAM_BUCKETS_S, self.counts)}
        buckets["le_inf"] = self.counts[-1]
        return {"count": self.count, "sum_s": round(self.sum_s, 9), "buckets": buckets}


def _fresh_sync_stats() -> Dict[str, Any]:
    return {
        # the gather protocol (utilities/distributed.py::_gather_all_leaves)
        "gathers": 0,
        "gather_errors": 0,
        "gather_leaves": 0,
        "payload_bytes_out": 0,
        "payload_bytes_in": 0,
        "transport_bytes": 0,
        "descriptor_rounds": 0,
        "payload_rounds": 0,
        # cumulative wall time split per collective round: the descriptor
        # exchange vs the padded payload exchange (seconds); with the round
        # counts above these give per-round averages, and the span
        # decomposition (observability/tracing.py) gives per-collective detail
        "descriptor_seconds": 0.0,
        "payload_seconds": 0.0,
        # gathers per transport label ("gather" for the protocol's rounds),
        # so the sync volume splits by backend
        "transports": {},
        # rounds whose exchanges spanned a PROPER SUBSET of the processes
        # (a ProcessGroup handle over some of the world)
        "subgroup_rounds": 0,
        # last participant set per transport label (gauge-like; what the
        # round physically touched)
        "participants": {},
        "groups": {},
        # packed-sync collective composition (sync_state_packed; the JAX
        # package records it at trace time, the port per call).
        # "collectives" counts STATES per collective kind;
        # "buckets" counts states per packed "<kind>/<dtype>" bucket;
        # collectives_before/after are the per-leaf vs actually-issued
        # collective counts, so before/after quantifies the bucketing win.
        "in_graph": {
            "syncs": 0,
            "states": 0,
            "bytes_traced": 0,
            "collectives": {},
            "axes": {},
            "buckets": {},
            "collectives_before": 0,
            "collectives_after": 0,
            # deduped bundles riding the packed buckets: how many bundle
            # syncs served >1 member (compute groups / shared-update
            # classes), and how many member states they served in total
            "dedup_groups": 0,
            "dedup_members": 0,
            # hierarchical syncs per level label (none in the port yet)
            "levels": {},
        },
    }


class TelemetryRegistry:
    """Thread-safe registry of per-metric counters/timers plus global sync stats.

    One process-global instance (:data:`TELEMETRY`) backs the whole library;
    constructing private instances is supported for tests.
    """

    def __init__(self, enabled: bool = True) -> None:
        self._lock = threading.Lock()
        self._enabled = enabled
        self._ordinals: Dict[str, int] = {}
        self._instances: Dict[str, "weakref.ref"] = {}
        self._metrics: Dict[str, Dict[str, Any]] = {}
        self._sync = _fresh_sync_stats()
        #: ``{(key, counter): int64 tensor}``: counts still on the device
        self._pending: Dict[Tuple[str, str], torch.Tensor] = {}

    # -- enablement (lock-free read: call sites gate on this every call) ----

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, on: bool = True) -> None:
        self._enabled = bool(on)

    def disable(self) -> None:
        self._enabled = False

    # -- key management ------------------------------------------------------

    def register(self, obj: Any) -> str:
        """Assign ``obj`` its stable instance key (``"<Class>#<ordinal>"``)."""
        cls = type(obj).__name__
        with self._lock:
            ordinal = self._ordinals.get(cls, 0)
            self._ordinals[cls] = ordinal + 1
            key = f"{cls}#{ordinal}"
            try:
                self._instances[key] = weakref.ref(obj)
            except TypeError:  # pragma: no cover - non-weakrefable object
                pass
            return key

    def _entry(self, key: str) -> Dict[str, Any]:
        entry = self._metrics.get(key)
        if entry is None:
            entry = {"counters": {}, "timers": {}}
            self._metrics[key] = entry
        return entry

    # -- recording -----------------------------------------------------------

    def inc(self, key: str, counter: str, n: int = 1) -> None:
        if not self._enabled:
            return
        with self._lock:
            counters = self._entry(key)["counters"]
            counters[counter] = counters.get(counter, 0) + n

    def record_call(self, key: str, counter: str, phase: str, seconds: float) -> None:
        """:meth:`inc` of ``counter`` and :meth:`observe` of ``phase`` in one
        acquisition of the lock: the instrumented calls' common pair."""
        if not self._enabled:
            return
        with self._lock:
            entry = self._metrics.get(key) or self._entry(key)
            counters, timers = entry["counters"], entry["timers"]
            counters[counter] = counters.get(counter, 0) + 1
            hist = timers.get(phase)
            if hist is None:
                hist = timers[phase] = _Histogram()
            hist.observe(seconds)

    def add_device(self, key: str, counter: str, n: torch.Tensor) -> None:
        """Add a device scalar ``n`` to ``key``'s ``counter`` without reading
        it: it accumulates on its device (one elementwise add) and reaches
        the counters at the next :meth:`snapshot` or :meth:`counter`. A
        total of 0 creates no counter, as :meth:`inc` is never called with
        one."""
        if not self._enabled:
            return
        with self._lock:
            acc = self._pending.get((key, counter))
            self._pending[(key, counter)] = n.to(torch.int64) if acc is None else acc + n

    def _drain_pending(self) -> None:
        """Read the device-side counts to the host (one read per device) and
        fold them into the counters. Called with the lock held."""
        if not self._pending:
            return
        by_device: Dict[torch.device, List[Tuple[Tuple[str, str], torch.Tensor]]] = {}
        for slot, acc in self._pending.items():
            by_device.setdefault(acc.device, []).append((slot, acc))
        self._pending = {}
        for entries in by_device.values():
            values = torch.stack([acc for _, acc in entries]).tolist()
            for ((key, counter), _), value in zip(entries, values):
                if value:
                    counters = self._entry(key)["counters"]
                    counters[counter] = counters.get(counter, 0) + int(value)

    def set_info(self, key: str, name: str, value: Any) -> None:
        """Attach a JSON-serializable info blob to ``key``'s snapshot entry
        (latest value wins — a gauge-like annotation, not a counter). Used
        for structured composition data, e.g. a collection's compute-group
        layout."""
        if not self._enabled:
            return
        with self._lock:
            self._entry(key).setdefault("info", {})[name] = value

    def observe(self, key: str, phase: str, seconds: float) -> None:
        if not self._enabled:
            return
        with self._lock:
            timers = self._entry(key)["timers"]
            hist = timers.get(phase)
            if hist is None:
                hist = timers[phase] = _Histogram()
            hist.observe(seconds)

    def record_gather(
        self,
        *,
        bytes_out: int,
        bytes_in: int,
        transport_bytes: int,
        descriptor_rounds: int,
        payload_rounds: int,
        world: int,
        members: Any,
        error: bool = False,
        leaves: int = 1,
        descriptor_s: float = 0.0,
        payload_s: float = 0.0,
        transport: str = "gather",
        participants: Optional[List[int]] = None,
    ) -> None:
        """One completed gather (``_gather_all_leaves``). ``leaves`` is how
        many state tensors the descriptor/payload rounds carried — the
        bundling win is ``gather_leaves / gathers`` leaves per gather.
        ``descriptor_s``/``payload_s`` split the gather's host time into its
        two rounds (under NCCL the payload round's time is enqueue time, see
        ``_gather_all_leaves``); ``transport`` is the backend label;
        ``participants`` is the peer set the rounds physically touched — a
        proper subset of the world counts as a subgroup round."""
        if not self._enabled:
            return
        group_label = ",".join(str(m) for m in members)
        with self._lock:
            s = self._sync
            s["gathers"] += 1
            s["transports"][transport] = s["transports"].get(transport, 0) + 1
            if participants is not None:
                s["participants"][transport] = [int(p) for p in participants]
                if world > 1 and len(participants) < world:
                    s["subgroup_rounds"] += 1
            if error:
                s["gather_errors"] += 1
            s["gather_leaves"] += int(leaves)
            s["payload_bytes_out"] += int(bytes_out)
            s["payload_bytes_in"] += int(bytes_in)
            s["transport_bytes"] += int(transport_bytes)
            s["descriptor_rounds"] += int(descriptor_rounds)
            s["payload_rounds"] += int(payload_rounds)
            s["descriptor_seconds"] = round(s["descriptor_seconds"] + float(descriptor_s), 9)
            s["payload_seconds"] = round(s["payload_seconds"] + float(payload_s), 9)
            g = s["groups"].setdefault(group_label, {"gathers": 0, "world": int(world)})
            g["gathers"] += 1
            g["world"] = int(world)

    def record_in_graph_sync(
        self,
        axis_name: Any,
        kinds: Dict[str, int],
        bytes_traced: int,
        *,
        buckets: Optional[Dict[str, int]] = None,
        collectives_before: int = 0,
        collectives_after: int = 0,
        groups: Optional[Dict[str, int]] = None,
        levels: Optional[List[str]] = None,
    ) -> None:
        """Record of one ``sync_state_packed`` call: which collectives the
        state bundle took (states per kind: ``psum``/``pmean``/``pmax``/
        ``pmin``/``all_gather``, the JAX package's names), its payload
        size, the packed bucket composition (``"<kind>/<dtype>" -> state
        count``), the per-leaf vs issued collective counts, and the
        deduped-bundle composition (``groups``: bundle label -> members it
        serves). The JAX package records this once per trace; the port's
        packed sync is eager, so once per call."""
        if not self._enabled:
            return
        with self._lock:
            ig = self._sync["in_graph"]
            ig["syncs"] += 1
            ig["states"] += sum(kinds.values())
            ig["bytes_traced"] += int(bytes_traced)
            ig["collectives_before"] += int(collectives_before)
            ig["collectives_after"] += int(collectives_after)
            for lvl in levels or ():
                ig["levels"][lvl] = ig["levels"].get(lvl, 0) + 1
            for n in (groups or {}).values():
                ig["dedup_groups"] += 1
                ig["dedup_members"] += int(n)
            for kind, n in kinds.items():
                ig["collectives"][kind] = ig["collectives"].get(kind, 0) + n
            for label, n in (buckets or {}).items():
                ig["buckets"][label] = ig["buckets"].get(label, 0) + n
            axis = repr(axis_name)
            ig["axes"][axis] = ig["axes"].get(axis, 0) + 1

    # -- reading -------------------------------------------------------------

    def counter(self, key: str, name: str, default: int = 0) -> int:
        """One counter's current value (``default`` when never recorded) —
        the cheap point read report builders use instead of a full
        :meth:`snapshot`."""
        with self._lock:
            self._drain_pending()
            entry = self._metrics.get(key)
            if entry is None:
                return default
            return entry["counters"].get(name, default)

    def _state_memory(self, key: str) -> Optional[Dict[str, Any]]:
        """The live ``state_memory_report()`` of ``key``'s instance (tensor
        metadata only), ``None`` when it has none or is gone."""
        ref = self._instances.get(key)
        obj = ref() if ref is not None else None
        report_fn = getattr(obj, "state_memory_report", None)
        if report_fn is None:
            return None
        try:
            return report_fn()
        except Exception:  # a snapshot never raises
            return None

    def snapshot(self, include_timers: bool = True) -> Dict[str, Any]:
        """JSON-serializable view: per-metric counters (+timers, +live state
        memory) and the global sync stats.

        Entries whose metric instance has been garbage-collected appear in
        THIS snapshot one final time marked ``"dead": true``, then are
        evicted from the registry — long-running sessions that churn through
        metric instances stay bounded instead of accumulating counters for
        objects that no longer exist. (Entries recorded directly by key,
        with no registered instance, are never evicted: the registry cannot
        know they are gone.)
        """
        with self._lock:
            self._drain_pending()
            dead = {key for key, ref in self._instances.items() if ref() is None}
            metrics: Dict[str, Any] = {}
            for key, entry in self._metrics.items():
                out: Dict[str, Any] = {"counters": dict(entry["counters"])}
                if include_timers and entry["timers"]:
                    out["timers"] = {phase: h.to_dict() for phase, h in entry["timers"].items()}
                if entry.get("info"):
                    out["info"] = dict(entry["info"])
                if key in dead:
                    out["dead"] = True
                metrics[key] = out
            for key in dead:
                del self._instances[key]
                self._metrics.pop(key, None)
            sync = {
                k: (dict(v) if isinstance(v, dict) and k != "in_graph" else v)
                for k, v in self._sync.items()
            }
            sync["groups"] = {k: dict(v) for k, v in self._sync["groups"].items()}
            sync["transports"] = dict(self._sync["transports"])
            ig = self._sync["in_graph"]
            sync["in_graph"] = {
                "syncs": ig["syncs"],
                "states": ig["states"],
                "bytes_traced": ig["bytes_traced"],
                "collectives": dict(ig["collectives"]),
                "axes": dict(ig["axes"]),
                "buckets": dict(ig["buckets"]),
                "collectives_before": ig["collectives_before"],
                "collectives_after": ig["collectives_after"],
                "dedup_groups": ig["dedup_groups"],
                "dedup_members": ig["dedup_members"],
                "levels": dict(ig["levels"]),
            }
        # state memory reads live objects outside the lock (it may touch
        # arbitrary metric code)
        for key, out in metrics.items():
            mem = self._state_memory(key)
            if mem is not None:
                out["state_memory"] = mem
        return {"enabled": self._enabled, "metrics": metrics, "sync": sync}

    def reset(self) -> None:
        """Clear all recorded data (keys/ordinals survive: live metrics keep
        their identity across a reset)."""
        with self._lock:
            self._metrics.clear()
            self._pending = {}
            self._sync = _fresh_sync_stats()


#: the process-global registry every instrumented call site records into
TELEMETRY = TelemetryRegistry()
