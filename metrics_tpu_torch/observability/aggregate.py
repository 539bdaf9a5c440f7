"""Fleet-wide telemetry: mergeable snapshots and cross-process aggregation.

Counterpart of ``metrics_tpu/observability/aggregate.py`` (a copy: the JAX
module imports no JAX at module level). A snapshot (:func:`~metrics_tpu_torch.observability.export.snapshot`) is one
process's view. At pod scale the operator needs ONE view of the whole job —
every process's counters, dispatch-latency histograms, retraces, and health
flags — without standing up a side-channel: this module makes the snapshot
itself **mergeable** and ships it over the library's own sync machinery.

Three pieces:

* **Declared reductions** (:data:`MERGE_RULES` / :func:`leaf_reduction`):
  every snapshot leaf has a declared merge semantic — counters sum, gauges
  take the max (or last value for annotations), histograms sum bucketwise,
  booleans OR, signature lists union. :func:`merge_snapshots` folds any
  number of snapshots into one by those rules; it is associative and
  ignores keys a process never recorded (empty snapshots are identities).
* **The canonical pytree form** (:func:`snapshot_pytree` /
  :func:`apply_pytree`): the snapshot's sum/max-reducible numeric leaves
  flattened to ``{"metrics/Accuracy#0/counters/update_calls": array, ...}``
  with a parallel ``{path: "sum"|"max"}`` spec — exactly the
  ``(state, reductions)`` contract of
  :func:`~metrics_tpu_torch.utilities.distributed.sync_state_packed`, so telemetry
  can ride the same bucketed collectives metric state does (one
  ``all_reduce`` per dtype for every counter and histogram bucket in the
  process, once the leaves are made tensors).
* **Eager aggregation** (:func:`aggregate_snapshots`): each process encodes
  its local snapshot as one JSON byte leaf and ships it through
  :func:`~metrics_tpu_torch.utilities.distributed.gather_all_pytrees` — the packed
  ragged transport the epoch-end state sync already uses (ONE descriptor
  round + ONE payload round for the whole fleet) — then merges the decoded
  snapshots host-side. The result keeps the **per-process breakdown**
  alongside the merged fleet view;
  ``render_prometheus(aggregated=True)`` renders it with ``process`` labels.
"""
import json
from fnmatch import fnmatchcase
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

#: max retained entries for "union"-reduced lists (retrace signatures)
_UNION_CAP = 16

#: declared merge semantics by snapshot path (first match wins; paths are
#: dotted key chains, matched with fnmatch where ``*`` spans dots too — order
#: specific rules before their catch-alls)
MERGE_RULES: Tuple[Tuple[str, str], ...] = (
    # per-metric section
    ("metrics.*.counters.*", "sum"),
    ("metrics.*.timers.*.buckets.*", "sum"),
    ("metrics.*.timers.*.count", "sum"),
    ("metrics.*.timers.*.sum_s", "sum"),
    ("metrics.*.dead", "any"),
    ("metrics.*.state_memory.total_bytes", "sum"),
    ("metrics.*.state_memory.*", "last"),
    ("metrics.*.info.*", "last"),
    # retrace ledger
    ("retrace.threshold", "max"),
    ("retrace.metrics.*.warned", "any"),
    ("retrace.metrics.*.signatures", "union"),
    ("retrace.metrics.*.*", "sum"),
    # sync transport stats
    ("sync.groups.*.world", "max"),
    ("sync.groups.*.*", "sum"),
    ("sync.participants.*", "last"),
    ("sync.*", "sum"),
    # event-log summary
    ("events.enabled", "any"),
    ("events.capacity", "max"),
    ("events.high_water", "max"),
    ("events.step", "max"),
    ("events.*", "sum"),
    # health ledger
    ("health.policy", "last"),
    ("health.*", "sum"),
    # collective-span tracker + straggler diagnostics: span volumes sum; the
    # straggler report is already fleet-wide, so the last publisher wins
    ("tracing.enabled", "any"),
    ("tracing.capacity", "max"),
    ("tracing.size", "sum"),
    ("tracing.recorded_total", "sum"),
    ("tracing.dropped", "sum"),
    ("tracing.by_kind.*", "sum"),
    ("tracing.*", "last"),
    # background sync engine: outcome counters sum; generations are per-key
    # monotonic watermarks (max), the live flag ORs
    ("async_sync.engine_alive", "any"),
    ("async_sync.generations.*", "max"),
    ("async_sync.*", "sum"),
    # serving plane: admission/flush/read outcome counters sum (including
    # the per-reason/per-trigger splits); occupancy gauges sum across
    # processes (fleet-resident rows), the high-water mark maxes
    ("serving.depth_high_water", "max"),
    ("serving.*", "sum"),
    # Pallas kernel suite: dispatch-decision counters sum across processes
    ("kernels.*", "sum"),
    # durability plane: checkpoint/spill/elastic counters sum; spill
    # occupancy gauges sum across processes (fleet-resident/spilled
    # totals), the high-water mark maxes
    ("durability.spilled_high_water", "max"),
    ("durability.*", "sum"),
    # resilience plane: counters sum; the membership epoch is a version —
    # the fleet view is the newest epoch any process has seen
    ("resilience.epoch", "max"),
    ("resilience.*", "sum"),
    # fast-path histograms (percentiles recomputed after the bucket merge;
    # the patterns span the nested ``window`` sub-dict too — windowed bucket
    # deltas sum elementwise exactly like the cumulative table, and windowed
    # percentiles are recomputed from the summed window buckets)
    ("histograms.*.buckets.*", "sum"),
    ("histograms.*.count", "sum"),
    ("histograms.*.sum", "sum"),
    ("histograms.*.p50", "recompute"),
    ("histograms.*.p95", "recompute"),
    ("histograms.*.p99", "recompute"),
    ("histograms.*.*", "last"),
    # SLO plane: event tallies (good/bad observations, breach transitions,
    # watchdog ticks) sum across processes; burn rates / budget / breach
    # state are DERIVED from the summed tallies after the merge — a fleet
    # burn rate is recomputed from fleet bad/total, never averaged; the
    # attained percentile takes the worst process pending recompute; declared
    # config (series, threshold, objective, windows) is identical everywhere
    # so the last writer wins
    ("slo.ticks", "sum"),
    ("slo.breaches_total", "sum"),
    ("slo.*.breaches_total", "sum"),
    ("slo.*.total", "sum"),
    ("slo.*.bad", "sum"),
    ("slo.*.burn_rate", "recompute"),
    ("slo.*.budget_remaining", "recompute"),
    ("slo.*.breached", "recompute"),
    ("slo.*.window_p", "max"),
    ("slo.*", "last"),
    # profiling plane: dispatch/sample tallies sum across processes; the
    # sampling stride is declared config (last writer wins), enablement ORs
    # (the split-latency histogram series merge under the histograms.*
    # rules above — buckets sum elementwise, percentiles recompute)
    ("profiling.enabled", "any"),
    ("profiling.sample_every", "last"),
    ("profiling.*", "sum"),
    # memory ledger: byte gauges sum across processes (fleet HBM footprint),
    # the high-water marks max — a fleet high-water is the worst process,
    # not a sum of unsynchronized peaks
    ("memory.high_water_bytes", "max"),
    ("memory.*", "sum"),
    # top level
    ("enabled", "any"),
    ("schema", "last"),
)


def leaf_reduction(path: Tuple[str, ...]) -> str:
    """The declared merge semantic for a snapshot leaf at ``path``.

    Unlisted leaves default to ``"last"`` (gauge-like annotation: the last
    process's value wins) — merging must never drop or invent keys.
    """
    dotted = ".".join(str(p) for p in path)
    for pattern, rule in MERGE_RULES:
        if fnmatchcase(dotted, pattern):
            return rule
    return "last"


def _merge_leaves(rule: str, values: List[Any]) -> Any:
    present = [v for v in values if v is not None]
    if not present:
        return None
    if rule == "sum":
        if all(isinstance(v, bool) for v in present):
            return any(present)
        try:
            return type(present[0])(sum(present))
        except TypeError:
            return present[-1]
    if rule == "max":
        try:
            return max(present)
        except TypeError:
            return present[-1]
    if rule == "any":
        return any(bool(v) for v in present)
    if rule == "union":
        out: List[Any] = []
        for v in present:
            for item in v if isinstance(v, (list, tuple)) else [v]:
                if item not in out:
                    out.append(item)
        return out[-_UNION_CAP:]
    # "last" and "recompute" (patched afterwards) both take the last value
    return present[-1]


def _merge_trees(snaps: List[Any], path: Tuple[str, ...]) -> Any:
    dicts = [s for s in snaps if isinstance(s, dict)]
    if dicts and len(dicts) == len([s for s in snaps if s is not None]):
        keys: List[str] = []
        for d in dicts:
            for k in d:
                if k not in keys:
                    keys.append(k)
        return {k: _merge_trees([d.get(k) for d in dicts], path + (k,)) for k in keys}
    return _merge_leaves(leaf_reduction(path), snaps)


def _recompute_percentiles(entry: Dict[str, Any], unit: Optional[str] = None) -> None:
    """Refresh a merged histogram entry's p50/p95/p99 from its (summed)
    bucket table — percentiles do not merge, buckets do. Recurses into the
    ``window`` sub-dict so merged *windowed* percentiles are likewise the
    percentiles of the elementwise-summed window buckets."""
    from metrics_tpu_torch.observability.histogram import Log2Histogram

    unit = entry.get("unit", unit or "s")
    buckets = entry.get("buckets")
    if not isinstance(buckets, dict):
        return
    hist = Log2Histogram(unit)
    counts = hist._counts
    for i, key in enumerate(k for k in buckets):
        if i < counts.shape[0]:
            counts[i] = int(buckets[key])
    hist._totals[0] = float(entry.get("count", 0))
    hist._totals[1] = float(entry.get("sum", 0.0))
    entry["p50"] = round(hist.percentile(50.0), 9)
    entry["p95"] = round(hist.percentile(95.0), 9)
    entry["p99"] = round(hist.percentile(99.0), 9)
    window = entry.get("window")
    if isinstance(window, dict):
        _recompute_percentiles(window, unit)


def _recompute_slo(slo_section: Dict[str, Any]) -> None:
    """Refresh a merged SLO section's derived fields from its (summed) event
    tallies — a fleet burn rate is bad/total over the *fleet* window, not an
    average of per-process rates, and the breach verdict follows from the
    recomputed rates."""
    from metrics_tpu_torch.observability.slo import burn_rate

    for status in slo_section.get("slos", {}).values():
        if not isinstance(status, dict):
            continue
        objective = float(status.get("objective", 0.99))
        for window in ("fast", "slow"):
            stats = status.get(window)
            if isinstance(stats, dict):
                stats["burn_rate"] = round(
                    burn_rate(
                        float(stats.get("bad", 0)), float(stats.get("total", 0)), objective
                    ),
                    6,
                )
        fast = status.get("fast", {}) if isinstance(status.get("fast"), dict) else {}
        slow = status.get("slow", {}) if isinstance(status.get("slow"), dict) else {}
        status["budget_remaining"] = round(
            max(0.0, 1.0 - float(slow.get("burn_rate", 0.0))), 6
        )
        status["breached"] = bool(
            float(fast.get("burn_rate", 0.0)) > 1.0
            and float(slow.get("burn_rate", 0.0)) > 1.0
            and int(fast.get("total", 0)) > 0
        )


def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold ``snaps`` into one snapshot by the declared reductions.

    Associative; an empty dict is an identity (a process that recorded
    nothing contributes nothing); ``{}`` for an empty list. Histogram
    percentiles are recomputed from the merged buckets.
    """
    snaps = [s for s in snaps if s]
    if not snaps:
        return {}
    merged = _merge_trees(list(snaps), ())
    for entry in merged.get("histograms", {}).values():
        if isinstance(entry, dict):
            _recompute_percentiles(entry)
    if isinstance(merged.get("slo"), dict):
        _recompute_slo(merged["slo"])
    for entry in merged.get("metrics", {}).values():
        for timer in (entry or {}).get("timers", {}).values():
            if isinstance(timer, dict) and "sum_s" in timer:
                timer["sum_s"] = round(float(timer["sum_s"]), 9)
    return merged


# ---------------------------------------------------------------------------
# canonical pytree form (the in-graph packed-sync contract)
# ---------------------------------------------------------------------------

#: reductions the pytree form can express in one collective
_PYTREE_REDUCTIONS = ("sum", "max")


def snapshot_pytree(
    snap: Optional[Dict[str, Any]] = None
) -> Tuple[Dict[str, Any], Dict[str, str]]:
    """The snapshot's sum/max-reducible numeric leaves as a flat
    ``(state, reductions)`` pair.

    ``state`` maps slash-joined paths to numpy scalars — plus one int64
    *vector* per fast-path histogram series (its whole bucket table) — and
    ``reductions`` declares ``"sum"`` or ``"max"`` per leaf: exactly the
    contract of :func:`~metrics_tpu_torch.utilities.distributed.sync_state_packed`
    (every counter and histogram bucket in the process rides one
    ``all_reduce`` per dtype) and of
    :func:`~metrics_tpu_torch.utilities.distributed.gather_all_pytrees`.
    Non-reducible leaves (strings, annotations, booleans) are omitted —
    :func:`apply_pytree` folds reduced values back into a full snapshot.
    """
    if snap is None:
        from metrics_tpu_torch.observability.export import snapshot as _snapshot

        snap = _snapshot()
    state: Dict[str, Any] = {}
    reductions: Dict[str, str] = {}

    def walk(node: Any, path: Tuple[str, ...]) -> None:
        if isinstance(node, dict):
            if len(path) == 2 and path[0] == "histograms" and "buckets" in node:
                counts = np.asarray(
                    [int(v) for v in node["buckets"].values()], dtype=np.int64
                )
                key = "/".join(path + ("buckets",))
                state[key] = counts
                reductions[key] = "sum"
                for field in ("count", "sum"):
                    fkey = "/".join(path + (field,))
                    state[fkey] = np.asarray(node.get(field, 0), dtype=np.float64)
                    reductions[fkey] = "sum"
                return
            for k, v in node.items():
                walk(v, path + (str(k),))
            return
        rule = leaf_reduction(path)
        if rule in _PYTREE_REDUCTIONS and isinstance(node, (int, float)) and not isinstance(node, bool):
            key = "/".join(path)
            dtype = np.int64 if isinstance(node, int) else np.float64
            state[key] = np.asarray(node, dtype=dtype)
            reductions[key] = rule

    walk(snap, ())
    return state, reductions


def apply_pytree(snap: Dict[str, Any], state: Dict[str, Any]) -> Dict[str, Any]:
    """A deep copy of ``snap`` with the pytree leaves replaced by (reduced)
    ``state`` values — the read-back half of :func:`snapshot_pytree` after an
    in-graph sync. Histogram percentiles are recomputed from the reduced
    buckets."""
    out = json.loads(json.dumps(snap))
    for key, value in state.items():
        path = key.split("/")
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        leaf = path[-1]
        arr = np.asarray(value)
        if leaf == "buckets" and isinstance(node.get("buckets"), dict):
            for name, v in zip(node["buckets"], arr.reshape(-1)):
                node["buckets"][name] = int(v)
        elif arr.ndim == 0:
            was_int = isinstance(node.get(leaf), int) and not isinstance(node.get(leaf), bool)
            node[leaf] = int(arr) if (was_int or arr.dtype.kind in "iu") else float(arr)
    for entry in out.get("histograms", {}).values():
        if isinstance(entry, dict):
            _recompute_percentiles(entry)
    if isinstance(out.get("slo"), dict):
        _recompute_slo(out["slo"])
    return out


# ---------------------------------------------------------------------------
# eager cross-process aggregation (dogfoods gather_all_pytrees)
# ---------------------------------------------------------------------------


def _host_bytes(buf: Any) -> bytes:
    """The bytes of one gathered uint8 leaf (a tensor or an array)."""
    if hasattr(buf, "detach"):
        from metrics_tpu_torch.utilities.data import to_host

        buf = to_host(buf.detach(), numpy=True)
    return np.asarray(buf, dtype=np.uint8).tobytes()


def aggregate_snapshots(
    snaps: Optional[List[Dict[str, Any]]] = None,
    *,
    transport: Optional[Callable[[List[Any]], List[Any]]] = None,
    include_timers: bool = True,
) -> Dict[str, Any]:
    """One fleet-wide snapshot with per-process breakdown.

    With ``snaps`` given, merges them directly (testing / offline analysis).
    Otherwise each process encodes its LOCAL snapshot as a single uint8 JSON
    leaf and ships it through ``transport`` — default
    :func:`~metrics_tpu_torch.utilities.distributed.gather_all_pytrees`, the same
    packed ragged protocol metric state syncs over: one descriptor round +
    one payload round carry every process's snapshot, ragged sizes and all.
    **Collective discipline applies**: like any gather, every participating
    process must call this the same number of times. Single-process runs
    degrade to aggregating the local snapshot alone.

    Returns::

        {"schema": 1, "aggregated": True, "process_count": N,
         "merged": <snapshot merged by the declared reductions>,
         "per_process": {"0": <snap>, ..., "N-1": <snap>}}

    ``merged`` has the ordinary snapshot layout (counters summed, gauges
    maxed, histogram buckets summed with recomputed percentiles);
    ``per_process`` keeps each process's full view, which
    ``render_prometheus(aggregated=True)`` renders with ``process`` labels.
    """
    if snaps is None:
        from metrics_tpu_torch.observability.export import snapshot as _snapshot
        from metrics_tpu_torch.utilities.distributed import gather_all_pytrees

        if transport is None:
            transport = gather_all_pytrees
        local = _snapshot(include_timers=include_timers)
        payload = torch.frombuffer(bytearray(json.dumps(local).encode("utf-8")), dtype=torch.uint8)
        # collective span around the snapshot shipment: the aggregation round
        # correlates across processes on the merged fleet timeline
        from metrics_tpu_torch.observability.tracing import TRACER

        with TRACER.collective_span("aggregate", bucket="snapshot", bytes=int(payload.numel())):
            gathered = transport([payload])[0]
        snaps = [json.loads(_host_bytes(buf).decode("utf-8")) for buf in gathered]
    snaps = list(snaps)
    from metrics_tpu_torch.observability.export import SCHEMA_VERSION

    return {
        "schema": SCHEMA_VERSION,
        "aggregated": True,
        "process_count": len(snaps),
        "merged": merge_snapshots(snaps),
        "per_process": {str(i): s for i, s in enumerate(snaps)},
    }
