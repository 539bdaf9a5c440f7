"""Snapshot assembly and export renderers.

Counterpart of ``metrics_tpu/observability/export.py`` (``snapshot``,
``dumps``, ``render_prometheus``), in the JAX package's layout: ``metrics``
(counters, timers, info blobs, live state memory), ``retrace``, ``sync``,
``events``, ``health``, ``histograms``, ``tracing`` (with the published
straggler report), ``async_sync``, ``serving``, ``kernels`` (dispatch counts
per op and path), ``durability``, ``resilience``, ``slo``, ``profiling`` and
``memory``.
:func:`render_prometheus` gives the Prometheus text exposition format: every
series carries ``# HELP`` / ``# TYPE`` metadata, histograms render as
``_bucket``/``_sum``/``_count``, and ``aggregated=True`` renders a fleet-wide
:func:`~metrics_tpu_torch.observability.aggregate.aggregate_snapshots` view
with ``process`` labels.
"""
import json
import sys
from typing import Any, Dict, List, Optional

from metrics_tpu_torch.kernels._common import dispatch_summary
from metrics_tpu_torch.observability import memory as _memory
from metrics_tpu_torch.observability import profiling as _profiling
from metrics_tpu_torch.observability import slo as _slo
from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.health import HEALTH
from metrics_tpu_torch.observability.histogram import HISTOGRAMS
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.observability.retrace import MONITOR
from metrics_tpu_torch.observability.tracing import TRACER

#: bumped when the snapshot layout changes incompatibly (the JAX package's)
SCHEMA_VERSION = 1

#: the series prefix, the JAX package's, so one dashboard reads both
_PROM_PREFIX = "metrics_tpu"

#: HELP strings per (unprefixed) series name; unlisted names degrade to a
#: generated one-liner, never to a missing header
_HELP: Dict[str, str] = {
    "calls_total": "Instrumented calls per metric instance and operation.",
    "eager_seconds": "Eager update/forward/compute wall time per metric.",
    "state_bytes": "Live metric state footprint (shape x itemsize).",
    "retrace_compiles_total": "Fresh CUDA graph captures forced by compiled dispatches.",
    "retrace_traces_total": "Pure-API traces recorded per metric.",
    "health_checks_total": "Health checks run per metric.",
    "processes": "Processes aggregated into this scrape.",
    "straggler_collectives": "Cross-process collectives the latest straggler report analyzed.",
    "straggler_fraction": "Fraction of analyzed collectives a process entered last.",
    "straggler_lag_seconds": "Arrival lag behind the earliest peer (clock-aligned quantiles).",
    "straggler_wait_seconds_total": "Time a process spent waiting for its slowest peer.",
    "straggler_transfer_seconds_total": "Post-barrier transfer time attributed to a process.",
    "straggler_flagged": "1 when the latest report flags the process as persistently slow.",
    "slo_budget_remaining": "Error budget left over the SLO's slow window (1 = untouched, 0 = exhausted).",
    "slo_burn_rate": "Error-budget burn rate per evaluation window (>1 exhausts the budget early).",
    "slo_breaches_total": "Transitions into breach per SLO (edge-triggered by the watchdog).",
    "slo_breached": "1 while the SLO is currently breached (both windows burning past budget).",
    "slo_window_p": "The SLO's target percentile estimated over its fast window.",
    "dispatch_host_queue_seconds": "Sampled dispatch host-enqueue wall time against an idle device (submit window of the profiling split).",
    "dispatch_device_seconds": "Sampled dispatch device execution window (between two CUDA events around the submit).",
    "profiling_sample_every": "Sampling stride of the dispatch profiler (0 = disarmed).",
    "profiling_dispatches_total": "Compiled dispatches counted per path while profiling is armed.",
    "profiling_samples_total": "Dispatches that paid the host/device decomposition per path.",
    "memory_owners": "State-bundle owners tracked by the memory ledger.",
    "memory_tracked_bytes": "Live device bytes across tracked state bundles (tensor metadata, no sync).",
    "memory_high_water_bytes": "Peak tracked device bytes observed (fleet view takes the max).",
    "memory_spilled_bytes": "Host bytes held by spilled tenant rows across tracked owners.",
    "memory_updates_total": "Ledger re-accounting events at the executable-invalidation seams.",
    "memory_pressure_events_total": "Watermark crossings that fired a pressure callback.",
    "memory_watermarks": "Armed pressure-watermark subscriptions.",
    "compute_groups": "Multi-member compute groups formed in a collection.",
    "compute_group_members": "Members served by one compute group's shared state.",
    "events_recorded_total": "Events appended to the structured event log.",
    "events_dropped_total": "Events evicted from the bounded event log.",
    "events_high_water": "Peak retained event count.",
    "events_by_kind_total": "Events recorded per kind.",
    "dispatch_seconds": "Compiled dispatch host wall time (fast-path log2 histogram).",
    "sync_round_trip_seconds": "Eager sync transport round-trip wall time.",
    "gather_payload_bytes": "Eager gather transport payload volume.",
    "sync_descriptor_seconds_total": "Cumulative descriptor-round wall time of eager gathers.",
    "sync_payload_seconds_total": "Cumulative payload-round wall time of eager gathers.",
    "tracing_spans_total": "Collective spans recorded by the fleet tracer.",
    "tracing_spans_dropped_total": "Collective spans evicted from the bounded span ledger.",
    "sync_transport_gathers_total": "Eager gather transports per backend label (gather=inline, dcn=async engine, loopback/sharded=strategy backends).",
    "sync_subgroup_rounds_total": "Transport rounds whose exchanges spanned a proper subgroup of the processes (true subgroup formation).",
    "sync_in_graph_level_syncs_total": "Hierarchical in-graph sync lowerings per level label (ici/dcn).",
    "kernel_dispatch_total": "Kernel launches (cuda) and plain-version runs (torch) per op.",
    "tenants": "Tenant-axis size of a multi-tenant wrapper.",
    "tenants_active": "Tenants that received at least one event row.",
    "tenant_rows_routed_total": "Event rows routed to tenant states.",
    "tenant_invalid_rate": "Fraction of routed rows with out-of-range tenant ids.",
    "async_sync_submitted_total": "Background syncs submitted to the async engine.",
    "async_sync_completed_total": "Background syncs resolved (fresh or stale).",
    "async_sync_failed_total": "Background syncs that exhausted their degraded-link policy.",
    "async_sync_retries_total": "Transport attempts the retry policy re-issued.",
    "async_sync_timeouts_total": "Transport rounds that exceeded their round timeout.",
    "async_sync_stale_serves_total": "Futures served from the last completed generation (stale policy).",
    "async_sync_quorum_syncs_total": "Background syncs reduced over the healthy subgroup (quorum policy).",
    "async_sync_degraded_rounds_total": "Transport rounds started with flagged degraded peers.",
    "async_sync_in_flight": "Background syncs queued or running right now.",
    "async_sync_coalesced_total": "Submissions served by an already-pending job for the same key (coalesce=True).",
    "serving_queues": "Live admission queues in the serving plane.",
    "serving_queue_depth_rows": "Rows resident across the serving plane's admission queues.",
    "serving_queue_depth_high_water": "Peak resident rows observed at a flush.",
    "serving_submitted_rows_total": "Event rows offered to the admission queues.",
    "serving_admitted_rows_total": "Event rows admitted past the backpressure policy.",
    "serving_shed_rows_total": "Event rows shed by the load-shedding policies (exactly accounted).",
    "serving_shed_by_reason_total": "Shed rows split by policy reason.",
    "serving_dispatched_rows_total": "Rows delivered to keyed update dispatches.",
    "serving_flushes_total": "Coalesced dispatches (micro-batch flushes).",
    "serving_flushes_by_trigger_total": "Flushes split by trigger (size/deadline/manual/close).",
    "serving_dispatch_errors_total": "Flush dispatches that raised (their rows count as shed).",
    "serving_reads_total": "SLO-governed per-tenant reads served.",
    "serving_cache_hits_total": "Reads served from a fresh result cache.",
    "serving_cache_misses_total": "Reads that had to wait for a fresh compute.",
    "serving_stale_serves_total": "Reads served a stale-within-budget cached generation.",
    "serving_refreshes_total": "Result-cache refreshes scheduled on the background engine.",
    "serving_coalesced_refreshes_total": "Stale reads that joined an in-flight refresh.",
    "serving_generation_bumps_total": "Write-generation bumps (one per dispatched flush).",
    "serving_tenant_cache_hits_total": "Reads served from cache by per-tenant generation freshness (global generation moved, requested tenants untouched).",
    "serving_ingest_seconds": "Admission-to-dispatch-complete wall time per event row.",
    "serving_queue_wait_seconds": "Submit-to-flush-start wall time per event row (host-queue component of ingest).",
    "serving_dispatch_seconds": "Flush-start-to-dispatch-complete wall time per event row (device component of ingest).",
    "serving_read_staleness_seconds": "Cache-generation age observed by scheduler reads (0 for fresh hits).",
    "serving_flush_seconds": "One coalesced keyed dispatch's wall time.",
    "serving_queue_depth": "Rows resident at flush time (log2 count histogram).",
    "durability_saves_total": "Checkpoint snapshots written (full + delta).",
    "durability_delta_saves_total": "Delta checkpoints (only dirty tenants stamped).",
    "durability_save_errors_total": "Snapshot writes that failed (crash/IO) before completing.",
    "durability_restores_total": "Checkpoint chains restored.",
    "durability_restore_errors_total": "Restores that found no complete snapshot.",
    "durability_bytes_written_total": "Checkpoint payload bytes written (post-encoding).",
    "durability_bytes_read_total": "Checkpoint payload bytes read at restore.",
    "durability_tenants_stamped_total": "Tenant rows written by delta checkpoints (the O(k) evidence).",
    "durability_evictions_total": "Tenants spilled to host memory (cold-tenant eviction).",
    "durability_fault_backs_total": "Spilled tenants faulted back to the device.",
    "durability_grows_total": "Elastic tenant-axis grows (pow2-padded capacity).",
    "durability_compactions_total": "Elastic tenant-axis compactions.",
    "durability_spillers": "Live tenant spillers in the durability plane.",
    "durability_spilled_tenants": "Tenants currently spilled to host memory.",
    "durability_resident_tenants": "Active tenants currently device-resident.",
    "durability_spilled_bytes": "Host bytes held by spilled tenant rows.",
    "durability_spilled_high_water": "Peak spilled-tenant count observed.",
    "durability_save_seconds": "One checkpoint snapshot write's wall time.",
    "durability_restore_seconds": "One checkpoint chain restore's wall time.",
    "durability_faultback_seconds": "One spill fault-back cohort's wall time.",
    "durability_auto_saves_total": "Background auto-save policy triggers (interval/dirty-threshold).",
    "resilience_faults_injected_total": "Faults fired by the installed FaultPlan (all seams).",
    "resilience_faults_by_seam_total": "Injected faults split by (seam, mode).",
    "resilience_detector_suspects_total": "Peers the phi-accrual detector promoted to failed.",
    "resilience_peer_failures_total": "Membership transitions marking a peer failed.",
    "resilience_peer_rejoins_total": "Membership transitions re-admitting a recovered peer.",
    "resilience_epoch_transitions_total": "Membership epoch bumps (failures + rejoins).",
    "resilience_policy_retries_total": "Backoff sleeps taken through the unified RetryPolicy.",
    "resilience_deadline_exhausted_total": "DeadlineBudget expiries surfaced to callers.",
    "resilience_breaker_opens_total": "Circuit breakers tripped open by consecutive failures.",
    "resilience_breaker_short_circuits_total": "Calls refused by an open circuit breaker.",
    "resilience_membership_epoch": "Current membership epoch (fleet view takes the max).",
}

#: the counter fields of the planes' sections, in the JAX package's order
_ASYNC_SYNC_FIELDS = (
    "submitted", "completed", "failed", "retries", "timeouts", "stale_serves", "quorum_syncs", "degraded_rounds",
    "coalesced",
)
_SERVING_FIELDS = (
    "submitted_rows", "admitted_rows", "shed_rows", "dispatched_rows", "flushes", "dispatch_errors", "reads",
    "cache_hits", "cache_misses", "stale_serves", "tenant_cache_hits", "refreshes", "coalesced_refreshes",
    "generation_bumps",
)
_DURABILITY_FIELDS = (
    "saves", "delta_saves", "auto_saves", "save_errors", "restores", "restore_errors", "bytes_written", "bytes_read",
    "tenants_stamped", "evictions", "fault_backs", "grows", "compactions",
)
_RESILIENCE_FIELDS = (
    "faults_injected", "detector_suspects", "peer_failures", "peer_rejoins", "epoch_transitions", "policy_retries",
    "deadline_exhausted", "breaker_opens", "breaker_short_circuits",
)


def snapshot(include_timers: bool = True) -> Dict[str, Any]:
    """One structured view of everything the port has recorded.

    Layout (``schema`` = 1, the JAX package's keys)::

        {
          "schema": 1,
          "enabled": bool,
          "metrics": {"Accuracy#0": {"counters": {...}, "timers": {...},
                                      "info": {...}, "state_memory": {...}}, ...},
          "retrace": {"threshold": int, "metrics": {key: {"compiles": int,
                       "traces": int, "warned": bool, "signatures": [...]}}},
          "sync": {"gathers": int, "payload_bytes_out": int, ...,
                   "groups": {...}, "in_graph": {...}},
          "events": {"capacity": int, "size": int, "high_water": int,
                     "recorded_total": int, "dropped": int, "step": int,
                     "by_kind": {...}},
          "health": {"policy": str, "unhealthy_total": int,
                     "metrics": {key: {"checks": int, "unhealthy": int,
                                        "nan": int, "inf": int,
                                        "zero_weight": int}}},
          "histograms": {"dispatch_seconds{path=keyed_scatter}": {"unit": "s",
                          "count": int, "sum": float, "buckets": {...},
                          "p50": float, "p95": float, "p99": float}, ...},
          "tracing": {"enabled": bool, "capacity": int, "size": int,
                      "recorded_total": int, "dropped": int,
                      "by_kind": {...}, "straggler": <fleet report or None>,
                      "host": {"capacity": int, "size": int, "recorded": int,
                               "dropped": int, "host_reads": int}},
          "async_sync": {"engine_alive": bool, "in_flight": int,
                         "submitted": int, ..., "generations": {key: int}},
          "serving": {"queues": int, "depth": int, "shed_by_reason": {...}, ...},
          "kernels": {"dispatch": {op: {"cuda": int, "torch": int}}},
          "resilience": {"policy_retries": int, "breaker_opens": int, ...},
          "slo": {"window_epoch_s": float, "breaches_total": int, "ticks": int,
                  "slos": {name: {...}}},
          "profiling": {"enabled": bool, "sample_every": int,
                        "dispatches": {path: int}, "samples": {path: int}},
          "memory": {"owners": int, "tracked_bytes": int,
                     "high_water_bytes": int, "spilled_bytes": int,
                     "updates": int, "pressure_events": int, "watermarks": int},
        }

    ``async_sync`` is ``{}`` until the first ``compute_async`` (or serving
    refresh) makes the background engine; ``serving`` is ``{}`` until the
    first admission queue is built, ``resilience`` until a policy decision
    is recorded, ``slo`` until the first SLO is declared, ``profiling``
    until :func:`~metrics_tpu_torch.observability.profiling.set_profiling`
    arms the sampler, and ``memory`` until the ledger tracks its first
    owner. Reading the snapshot reads the device-side counts
    (``invalid_tenant_ids``) to the host once, and notes the compiled health
    guard's completed flag copies. Always JSON-serializable, and mergeable
    across processes by the declared reductions
    (:func:`~metrics_tpu_torch.observability.aggregate.aggregate_snapshots`).
    """
    snap = TELEMETRY.snapshot(include_timers=include_timers)
    snap["schema"] = SCHEMA_VERSION
    snap["retrace"] = MONITOR.snapshot()
    snap["events"] = EVENTS.summary()
    snap["health"] = HEALTH.summary()
    snap["histograms"] = HISTOGRAMS.snapshot()
    snap["tracing"] = TRACER.summary()
    # the planes' sections are read only where their modules were imported:
    # a process that never serves keeps its snapshot and its imports clean
    for section, module in (
        ("async_sync", "metrics_tpu_torch.utilities.async_sync"),
        ("serving", "metrics_tpu_torch.serving.telemetry"),
        ("durability", "metrics_tpu_torch.durability.telemetry"),
        ("resilience", "metrics_tpu_torch.resilience.telemetry"),
    ):
        loaded = sys.modules.get(module)
        snap[section] = loaded.summary() if loaded is not None else {}
    snap["kernels"] = dispatch_summary()
    snap["slo"] = _slo.summary()
    snap["profiling"] = _profiling.summary()
    snap["memory"] = _memory.summary()
    return snap


def _prom_label(value: str) -> str:
    # the exposition format requires \\, \" and \n escaped in label values
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_le(bound_key: str) -> str:
    """``le_...`` bucket-table key -> exposition ``le`` label value."""
    le = bound_key[len("le_"):]
    if le.endswith("s"):
        le = le[:-1]
    return "+Inf" if le == "inf" else le


class _Renderer:
    """Line emitter tracking per-family ``# HELP`` / ``# TYPE`` metadata so
    every series declares itself exactly once per scrape."""

    def __init__(self) -> None:
        self.lines: List[str] = []
        self._seen: set = set()

    def _meta(self, full: str, type_: str, name: str) -> None:
        if full in self._seen:
            return
        self._seen.add(full)
        help_ = _HELP.get(name, name.replace("_", " "))
        self.lines.append(f"# HELP {full} {help_}")
        self.lines.append(f"# TYPE {full} {type_}")

    def _sample(self, full: str, labels: Dict[str, str], value: Any) -> None:
        label_str = ",".join(f'{k}="{_prom_label(str(v))}"' for k, v in labels.items())
        self.lines.append(f"{full}{{{label_str}}} {value}" if label_str else f"{full} {value}")

    def emit(self, name: str, labels: Dict[str, str], value: Any, type_: str = "gauge") -> None:
        full = f"{_PROM_PREFIX}_{name}"
        self._meta(full, type_, name)
        self._sample(full, labels, value)

    def emit_histogram(
        self, name: str, labels: Dict[str, str], buckets: Dict[str, int], sum_: float, count: int
    ) -> None:
        """One histogram family: cumulative ``_bucket{le=...}`` samples (the
        ``buckets`` table is per-bucket), then ``_sum`` and ``_count``."""
        full = f"{_PROM_PREFIX}_{name}"
        self._meta(full, "histogram", name)
        cumulative = 0
        for bound_key, n in buckets.items():
            cumulative += n
            self._sample(f"{full}_bucket", {**labels, "le": _prom_le(bound_key)}, cumulative)
        self._sample(f"{full}_sum", labels, sum_)
        self._sample(f"{full}_count", labels, count)


def _render_metrics(snap: Dict[str, Any], base: Dict[str, str], out: _Renderer) -> None:
    for key, entry in sorted(snap.get("metrics", {}).items()):
        labels = {**base, "metric": key}
        for counter, value in sorted(entry.get("counters", {}).items()):
            out.emit("calls_total", {**labels, "op": counter}, value, "counter")
        for phase, hist in sorted(entry.get("timers", {}).items()):
            out.emit_histogram("eager_seconds", {**labels, "phase": phase}, hist["buckets"], hist["sum_s"], hist["count"])
        mem = entry.get("state_memory")
        if mem is not None:
            out.emit("state_bytes", labels, mem.get("total_bytes", 0))
        cg = entry.get("info", {}).get("compute_groups")
        if cg is not None:
            # group composition as gauges: group count, plus members served
            # per group (labeled by the group owner's member name)
            out.emit("compute_groups", labels, len(cg.get("groups", {})))
            for owner, members in sorted(cg.get("groups", {}).items()):
                out.emit("compute_group_members", {**labels, "group": owner}, len(members))
        sk = entry.get("info", {}).get("sketch")
        if sk is not None:
            # sketched state: size knobs as gauges, overflow (clipped scores)
            # and merge activity as counters
            sk_labels = {**labels, "kind": str(sk.get("kind", ""))}
            out.emit("sketch_bins", sk_labels, sk.get("bins", sk.get("capacity", 0)))
            out.emit("sketch_overflow_total", sk_labels, sk.get("overflow", 0), "counter")
            out.emit("sketch_merges_total", sk_labels, entry.get("counters", {}).get("sketch_merges", 0), "counter")
        tr = entry.get("info", {}).get("tenant_report")
        if tr is not None:
            # the multi-tenant drill-down rollup (the full report is the blob)
            out.emit("tenants", labels, tr.get("tenants", 0))
            out.emit("tenants_active", labels, tr.get("occupancy", {}).get("active", 0))
            out.emit("tenant_rows_routed_total", labels, tr.get("rows_routed", 0), "counter")
            out.emit("tenant_invalid_rate", labels, tr.get("invalid_rate", 0.0))
    for key, rec in sorted(snap.get("retrace", {}).get("metrics", {}).items()):
        out.emit("retrace_compiles_total", {**base, "metric": key}, rec["compiles"], "counter")
        out.emit("retrace_traces_total", {**base, "metric": key}, rec["traces"], "counter")


def _render_sync(snap: Dict[str, Any], base: Dict[str, str], out: _Renderer) -> None:
    sync = snap.get("sync", {})
    for field in (
        "gathers",
        "gather_errors",
        "gather_leaves",
        "payload_bytes_out",
        "payload_bytes_in",
        "transport_bytes",
        "descriptor_rounds",
        "payload_rounds",
        "descriptor_seconds",
        "payload_seconds",
        "subgroup_rounds",
    ):
        if field in sync:
            out.emit(f"sync_{field}_total", base, sync[field], "counter")
    for transport, n in sorted(sync.get("transports", {}).items()):
        out.emit("sync_transport_gathers_total", {**base, "transport": transport}, n, "counter")
    in_graph = sync.get("in_graph", {})
    for kind, n in sorted(in_graph.get("collectives", {}).items()):
        out.emit("sync_in_graph_collectives_total", {**base, "kind": kind}, n, "counter")
    for bucket, n in sorted(in_graph.get("buckets", {}).items()):
        out.emit("sync_in_graph_bucket_states_total", {**base, "bucket": bucket}, n, "counter")
    for level, n in sorted(in_graph.get("levels", {}).items()):
        out.emit("sync_in_graph_level_syncs_total", {**base, "level": level}, n, "counter")
    for field in ("collectives_before", "collectives_after", "dedup_groups", "dedup_members"):
        if field in in_graph:
            out.emit(f"sync_in_graph_{field}_total", base, in_graph[field], "counter")


def _render_planes(snap: Dict[str, Any], base: Dict[str, str], out: _Renderer) -> None:
    """The ``async_sync``, ``serving``, ``durability``, ``resilience``, ``slo``,
    ``profiling`` and ``memory`` families under the JAX package's series
    names."""
    async_sync = snap.get("async_sync", {})
    if async_sync:
        for field in _ASYNC_SYNC_FIELDS:
            if field in async_sync:
                out.emit(f"async_sync_{field}_total", base, async_sync[field], "counter")
        out.emit("async_sync_in_flight", base, async_sync.get("in_flight", 0))
    serving = snap.get("serving", {})
    if serving:
        out.emit("serving_queues", base, serving.get("queues", 0))
        out.emit("serving_queue_depth_rows", base, serving.get("depth", 0))
        out.emit("serving_queue_depth_high_water", base, serving.get("depth_high_water", 0))
        for field in _SERVING_FIELDS:
            if field in serving:
                out.emit(f"serving_{field}_total", base, serving[field], "counter")
        for reason, n in sorted(serving.get("shed_by_reason", {}).items()):
            out.emit("serving_shed_by_reason_total", {**base, "reason": reason}, n, "counter")
        for trigger, n in sorted(serving.get("flushes_by_trigger", {}).items()):
            out.emit("serving_flushes_by_trigger_total", {**base, "trigger": trigger}, n, "counter")
    durability = snap.get("durability", {})
    if durability:
        # checkpoint/spill/elastic outcomes are counters, spill occupancy
        # gauges (the save/restore/fault-back histograms ride the
        # histograms section)
        for field in _DURABILITY_FIELDS:
            if field in durability:
                out.emit(f"durability_{field}_total", base, durability[field], "counter")
        for gauge in ("spillers", "spilled_tenants", "resident_tenants", "spilled_bytes", "spilled_high_water"):
            if gauge in durability:
                out.emit(f"durability_{gauge}", base, durability[gauge])
    resilience = snap.get("resilience", {})
    if resilience:
        for field in _RESILIENCE_FIELDS:
            if field in resilience:
                out.emit(f"resilience_{field}_total", base, resilience[field], "counter")
        if "epoch" in resilience:
            out.emit("resilience_membership_epoch", base, resilience["epoch"])
        for key, n in sorted(resilience.get("faults_by_seam", {}).items()):
            seam, _, mode = key.rpartition(":")
            out.emit("resilience_faults_by_seam_total", {**base, "seam": seam, "mode": mode}, n, "counter")
    slo = snap.get("slo", {})
    for name, st in sorted(slo.get("slos", {}).items()):
        # per-declaration budget/burn gauges plus the edge-triggered breach
        # transition counter
        labels = {**base, "slo": name, "series": str(st.get("series", ""))}
        out.emit("slo_budget_remaining", labels, st.get("budget_remaining", 1.0))
        for window in ("fast", "slow"):
            out.emit("slo_burn_rate", {**labels, "window": window}, st.get(window, {}).get("burn_rate", 0.0))
        out.emit("slo_window_p", labels, st.get("window_p", 0.0))
        out.emit("slo_breached", labels, 1 if st.get("breached") else 0)
        out.emit("slo_breaches_total", labels, st.get("breaches_total", 0), "counter")
    profiling = snap.get("profiling", {})
    if profiling:
        # the stride as a gauge, the per-path tallies as counters (the split
        # histograms ride the histograms section)
        out.emit("profiling_sample_every", base, profiling.get("sample_every", 0))
        for field in ("dispatches", "samples"):
            for path, n in sorted(profiling.get(field, {}).items()):
                out.emit(f"profiling_{field}_total", {**base, "path": path}, n, "counter")
    memory = snap.get("memory", {})
    if memory:
        for gauge in ("owners", "tracked_bytes", "high_water_bytes", "spilled_bytes", "watermarks"):
            if gauge in memory:
                out.emit(f"memory_{gauge}", base, memory[gauge])
        for field in ("updates", "pressure_events"):
            if field in memory:
                out.emit(f"memory_{field}_total", base, memory[field], "counter")


def _render_tracing(tracing: Dict[str, Any], base: Dict[str, str], out: _Renderer) -> None:
    out.emit("tracing_spans_total", base, tracing.get("recorded_total", 0), "counter")
    out.emit("tracing_spans_dropped_total", base, tracing.get("dropped", 0), "counter")
    report = tracing.get("straggler") or {}
    if not report:
        return
    # per-peer skew/lag of the latest published fleet report (label "peer":
    # "process" is the aggregated renderer's label for the scraping process)
    out.emit("straggler_collectives", base, report.get("collectives", 0))
    flagged = {int(p) for p in report.get("flagged", [])}
    for peer in sorted(report.get("processes", {}), key=lambda p: (len(p), p)):
        entry = report["processes"][peer]
        labels = {**base, "peer": peer}
        out.emit("straggler_fraction", labels, entry.get("straggler_fraction", 0.0))
        for q in ("p50", "p95"):
            out.emit("straggler_lag_seconds", {**labels, "quantile": q}, entry.get(f"lag_{q}_s", 0.0))
        out.emit("straggler_wait_seconds_total", labels, entry.get("wait_s", 0.0), "counter")
        out.emit("straggler_transfer_seconds_total", labels, entry.get("transfer_s", 0.0), "counter")
        out.emit("straggler_flagged", labels, 1 if int(peer) in flagged else 0)


def _render_snapshot(snap: Dict[str, Any], base: Dict[str, str], out: _Renderer) -> None:
    """One process's snapshot, the sections in the JAX package's order;
    ``base`` labels (``process``) ride every sample."""
    _render_metrics(snap, base, out)
    _render_sync(snap, base, out)
    _render_planes(snap, base, out)
    for op, paths in sorted(snap.get("kernels", {}).get("dispatch", {}).items()):
        # one series per (kernel op, path): launches on the card ("cuda")
        # and plain-version runs on the CPU ("torch")
        for path, n in sorted(paths.items()):
            out.emit("kernel_dispatch_total", {**base, "op": op, "path": path}, n, "counter")
    events = snap.get("events", {})
    if events:
        out.emit("events_recorded_total", base, events.get("recorded_total", 0), "counter")
        out.emit("events_dropped_total", base, events.get("dropped", 0), "counter")
        out.emit("events_high_water", base, events.get("high_water", 0))
        for kind, n in sorted(events.get("by_kind", {}).items()):
            out.emit("events_by_kind_total", {**base, "kind": kind}, n, "counter")
    for key, rec in sorted(snap.get("health", {}).get("metrics", {}).items()):
        out.emit("health_checks_total", {**base, "metric": key}, rec.get("checks", 0), "counter")
        for kind in ("unhealthy", "nan", "inf", "zero_weight"):
            out.emit(f"health_{kind}_total", {**base, "metric": key}, rec.get(kind, 0), "counter")
    for series in sorted(snap.get("histograms", {})):
        entry = snap["histograms"][series]
        out.emit_histogram(
            entry.get("name", series), {**base, **entry.get("labels", {})}, entry["buckets"], entry["sum"],
            entry["count"],
        )
    tracing = snap.get("tracing", {})
    if tracing:
        _render_tracing(tracing, base, out)


def render_prometheus(snap: Optional[Dict[str, Any]] = None, *, aggregated: bool = False) -> str:
    """Render a snapshot (default: a fresh :func:`snapshot`) in the
    Prometheus text exposition format (0.0.4).

    ``aggregated=True`` (or an
    :func:`~metrics_tpu_torch.observability.aggregate.aggregate_snapshots`
    result as ``snap``) renders the FLEET view: every process's series with
    a ``process="<index>"`` label plus a ``metrics_tpu_processes`` gauge.
    With ``aggregated=True`` and no ``snap`` the local process gathers the
    fleet's snapshots first (a collective: all processes call together)."""
    if snap is None:
        if aggregated:
            from metrics_tpu_torch.observability.aggregate import aggregate_snapshots

            snap = aggregate_snapshots()
        else:
            snap = snapshot()
    out = _Renderer()
    if snap.get("aggregated"):
        out.emit("processes", {}, snap.get("process_count", 0))
        for proc in sorted(snap.get("per_process", {}), key=lambda p: (len(p), p)):
            _render_snapshot(snap["per_process"][proc], {"process": proc}, out)
    else:
        _render_snapshot(snap, {}, out)
    return "\n".join(out.lines) + "\n"


def dumps(include_timers: bool = True, **json_kwargs: Any) -> str:
    """``json.dumps`` of :func:`snapshot` — one line unless told otherwise."""
    return json.dumps(snapshot(include_timers=include_timers), **json_kwargs)
