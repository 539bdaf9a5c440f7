"""Snapshot assembly and export renderers.

Counterpart of ``metrics_tpu/observability/export.py`` (``snapshot``,
``dumps``, ``render_prometheus``), covering the sections the port records
so far: ``metrics`` (counters, timers, info blobs), ``sync``, ``events``,
``histograms``, ``tracing`` (the span tracker's summary), ``async_sync``
(the background engine), ``serving`` (the admission queues and the
scheduler), ``resilience`` (the policy decisions) and ``kernels`` (dispatch
counts per op and path). The JAX package's ``retrace``, ``health``,
``durability``, ``slo``, ``profiling`` and ``memory`` sections come with the
planes that fill them (ROADMAP queue A items 13 and 14); until then they are
absent from the port's snapshot, and a renderer given the JAX package's
layout renders the covered sections in the same text. :func:`render_prometheus`
gives the Prometheus text exposition format: every series carries
``# HELP`` / ``# TYPE`` metadata, histograms render as ``_bucket``/``_sum``/
``_count``.
"""
import json
import sys
from typing import Any, Dict, List, Optional

from metrics_tpu_torch.kernels._common import dispatch_summary
from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.histogram import HISTOGRAMS
from metrics_tpu_torch.observability.registry import TELEMETRY
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
_RESILIENCE_FIELDS = (
    "faults_injected", "detector_suspects", "peer_failures", "peer_rejoins", "epoch_transitions", "policy_retries",
    "deadline_exhausted", "breaker_opens", "breaker_short_circuits",
)


def snapshot(include_timers: bool = True) -> Dict[str, Any]:
    """One structured view of everything the port has recorded.

    Layout (``schema`` = 1, the JAX package's keys for the sections the
    port covers)::

        {
          "schema": 1,
          "enabled": bool,
          "metrics": {"Accuracy#0": {"counters": {...}, "timers": {...},
                                      "info": {...}}, ...},
          "sync": {"gathers": int, "payload_bytes_out": int, ...,
                   "groups": {...}, "in_graph": {...}},
          "events": {"capacity": int, "size": int, "high_water": int,
                     "recorded_total": int, "dropped": int, "step": int,
                     "by_kind": {...}},
          "histograms": {"dispatch_seconds{path=keyed_scatter}": {"unit": "s",
                          "count": int, "sum": float, "buckets": {...},
                          "p50": float, "p95": float, "p99": float}, ...},
          "tracing": {"enabled": bool, "capacity": int, "size": int,
                      "recorded_total": int, "dropped": int,
                      "by_kind": {...}, "straggler": None},
          "async_sync": {"engine_alive": bool, "in_flight": int,
                         "submitted": int, "completed": int, "failed": int,
                         "retries": int, "timeouts": int, "stale_serves": int,
                         "quorum_syncs": int, "degraded_rounds": int,
                         "coalesced": int, "generations": {key: int}},
          "serving": {"queues": int, "depth": int, "admitted_rows": int,
                      "shed_rows": int, "shed_by_reason": {...},
                      "dispatched_rows": int, "flushes": int,
                      "flushes_by_trigger": {...}, "reads": int, ...},
          "resilience": {"policy_retries": int, "breaker_opens": int, ...},
          "kernels": {"dispatch": {op: {"cuda": int, "torch": int}}},
        }

    ``async_sync`` is ``{}`` until the first ``compute_async`` (or serving
    refresh) makes the background engine; ``serving`` is ``{}`` until the
    first admission queue is built, and ``resilience`` until a policy
    decision is recorded. Reading the snapshot reads the device-side counts
    (``invalid_tenant_ids``) to the host once. Always JSON-serializable.
    """
    snap = TELEMETRY.snapshot(include_timers=include_timers)
    snap["schema"] = SCHEMA_VERSION
    snap["events"] = EVENTS.summary()
    snap["histograms"] = HISTOGRAMS.snapshot()
    snap["tracing"] = TRACER.summary()
    # the planes' sections are read only where their modules were imported:
    # a process that never serves keeps its snapshot and its imports clean
    for section, module in (
        ("async_sync", "metrics_tpu_torch.utilities.async_sync"),
        ("serving", "metrics_tpu_torch.serving.telemetry"),
        ("resilience", "metrics_tpu_torch.resilience.telemetry"),
    ):
        loaded = sys.modules.get(module)
        snap[section] = loaded.summary() if loaded is not None else {}
    snap["kernels"] = dispatch_summary()
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


def _render_metrics(snap: Dict[str, Any], out: _Renderer) -> None:
    for key, entry in sorted(snap.get("metrics", {}).items()):
        for counter, value in sorted(entry.get("counters", {}).items()):
            out.emit("calls_total", {"metric": key, "op": counter}, value, "counter")
        for phase, hist in sorted(entry.get("timers", {}).items()):
            out.emit_histogram(
                "eager_seconds", {"metric": key, "phase": phase}, hist["buckets"], hist["sum_s"], hist["count"]
            )
        cg = entry.get("info", {}).get("compute_groups")
        if cg is not None:
            # group composition as gauges: group count, plus members served
            # per group (labeled by the group owner's member name)
            out.emit("compute_groups", {"metric": key}, len(cg.get("groups", {})))
            for owner, members in sorted(cg.get("groups", {}).items()):
                out.emit("compute_group_members", {"metric": key, "group": owner}, len(members))
        sk = entry.get("info", {}).get("sketch")
        if sk is not None:
            # sketched state: size knobs as gauges, overflow (clipped scores)
            # and merge activity as counters
            labels = {"metric": key, "kind": str(sk.get("kind", ""))}
            out.emit("sketch_bins", labels, sk.get("bins", sk.get("capacity", 0)))
            out.emit("sketch_overflow_total", labels, sk.get("overflow", 0), "counter")
            out.emit("sketch_merges_total", labels, entry.get("counters", {}).get("sketch_merges", 0), "counter")
        tr = entry.get("info", {}).get("tenant_report")
        if tr is not None:
            # the multi-tenant drill-down rollup (the full report is the blob)
            labels = {"metric": key}
            out.emit("tenants", labels, tr.get("tenants", 0))
            out.emit("tenants_active", labels, tr.get("occupancy", {}).get("active", 0))
            out.emit("tenant_rows_routed_total", labels, tr.get("rows_routed", 0), "counter")
            out.emit("tenant_invalid_rate", labels, tr.get("invalid_rate", 0.0))


def _render_sync(snap: Dict[str, Any], out: _Renderer) -> None:
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
            out.emit(f"sync_{field}_total", {}, sync[field], "counter")
    for transport, n in sorted(sync.get("transports", {}).items()):
        out.emit("sync_transport_gathers_total", {"transport": transport}, n, "counter")
    in_graph = sync.get("in_graph", {})
    for kind, n in sorted(in_graph.get("collectives", {}).items()):
        out.emit("sync_in_graph_collectives_total", {"kind": kind}, n, "counter")
    for bucket, n in sorted(in_graph.get("buckets", {}).items()):
        out.emit("sync_in_graph_bucket_states_total", {"bucket": bucket}, n, "counter")
    for level, n in sorted(in_graph.get("levels", {}).items()):
        out.emit("sync_in_graph_level_syncs_total", {"level": level}, n, "counter")
    for field in ("collectives_before", "collectives_after", "dedup_groups", "dedup_members"):
        if field in in_graph:
            out.emit(f"sync_in_graph_{field}_total", {}, in_graph[field], "counter")


def _render_planes(snap: Dict[str, Any], out: _Renderer) -> None:
    """The ``async_sync``, ``serving`` and ``resilience`` families under the
    JAX package's series names."""
    async_sync = snap.get("async_sync", {})
    if async_sync:
        for field in _ASYNC_SYNC_FIELDS:
            if field in async_sync:
                out.emit(f"async_sync_{field}_total", {}, async_sync[field], "counter")
        out.emit("async_sync_in_flight", {}, async_sync.get("in_flight", 0))
    serving = snap.get("serving", {})
    if serving:
        out.emit("serving_queues", {}, serving.get("queues", 0))
        out.emit("serving_queue_depth_rows", {}, serving.get("depth", 0))
        out.emit("serving_queue_depth_high_water", {}, serving.get("depth_high_water", 0))
        for field in _SERVING_FIELDS:
            if field in serving:
                out.emit(f"serving_{field}_total", {}, serving[field], "counter")
        for reason, n in sorted(serving.get("shed_by_reason", {}).items()):
            out.emit("serving_shed_by_reason_total", {"reason": reason}, n, "counter")
        for trigger, n in sorted(serving.get("flushes_by_trigger", {}).items()):
            out.emit("serving_flushes_by_trigger_total", {"trigger": trigger}, n, "counter")
    resilience = snap.get("resilience", {})
    if resilience:
        for field in _RESILIENCE_FIELDS:
            if field in resilience:
                out.emit(f"resilience_{field}_total", {}, resilience[field], "counter")
        if "epoch" in resilience:
            out.emit("resilience_membership_epoch", {}, resilience["epoch"])
        for key, n in sorted(resilience.get("faults_by_seam", {}).items()):
            seam, _, mode = key.rpartition(":")
            out.emit("resilience_faults_by_seam_total", {"seam": seam, "mode": mode}, n, "counter")


def render_prometheus(snap: Optional[Dict[str, Any]] = None) -> str:
    """Render a snapshot (default: a fresh :func:`snapshot`) in the
    Prometheus text exposition format (0.0.4), the sections in the JAX
    package's order."""
    if snap is None:
        snap = snapshot()
    out = _Renderer()
    _render_metrics(snap, out)
    _render_sync(snap, out)
    _render_planes(snap, out)
    for op, paths in sorted(snap.get("kernels", {}).get("dispatch", {}).items()):
        # one series per (kernel op, path): launches on the card ("cuda")
        # and plain-version runs on the CPU ("torch")
        for path, n in sorted(paths.items()):
            out.emit("kernel_dispatch_total", {"op": op, "path": path}, n, "counter")
    events = snap.get("events", {})
    if events:
        out.emit("events_recorded_total", {}, events.get("recorded_total", 0), "counter")
        out.emit("events_dropped_total", {}, events.get("dropped", 0), "counter")
        out.emit("events_high_water", {}, events.get("high_water", 0))
        for kind, n in sorted(events.get("by_kind", {}).items()):
            out.emit("events_by_kind_total", {"kind": kind}, n, "counter")
    for series in sorted(snap.get("histograms", {})):
        entry = snap["histograms"][series]
        out.emit_histogram(
            entry.get("name", series), dict(entry.get("labels", {})), entry["buckets"], entry["sum"], entry["count"]
        )
    tracing = snap.get("tracing", {})
    if tracing:
        out.emit("tracing_spans_total", {}, tracing.get("recorded_total", 0), "counter")
        out.emit("tracing_spans_dropped_total", {}, tracing.get("dropped", 0), "counter")
    return "\n".join(out.lines) + "\n"


def dumps(include_timers: bool = True, **json_kwargs: Any) -> str:
    """``json.dumps`` of :func:`snapshot` — one line unless told otherwise."""
    return json.dumps(snapshot(include_timers=include_timers), **json_kwargs)
