"""Incremental checkpointing: mergeable snapshots with a crash-safe manifest
protocol.

Counterpart of ``metrics_tpu/durability/checkpoint.py``, with its on-disk
format byte for byte: a snapshot is a directory of payload shards (each
leaf's raw numpy bytes, back to back) and one ``MANIFEST.json`` holding the
layout rows (bundle, leaf name, shape, numpy dtype name, declared reduction,
byte offset and count), the delta's ``tenants`` and the keyed geometry. A
snapshot written by either package restores into the other.

* **Mergeable by construction.** A shard holds one participant's partial
  state; a multi-shard snapshot is re-reduced by the declared reductions at
  restore (:func:`merge_shard_states`).
* **Topology-flexible restore.** Only the logical ``[:num_tenants]`` rows
  are saved, as host bytes: a snapshot restores into a metric of another
  capacity, onto another device (the CPU or the card), or through a
  transport's ``place_state`` (a
  :class:`~metrics_tpu_torch.transport.sharded.ShardedTransport` shards the
  tenant axis).
* **Delta checkpoints.** A save stamps only the tenants whose write marks
  moved since the previous save (the serving scheduler's per-tenant write
  generations when it owns the metric, the traffic ledger's routed-row
  counts otherwise), so touching k of N tenants writes an O(k) payload.
  Restore replays the chain: the full snapshot, then each delta's rows.

**The dtype rule.** Each leaf is saved in the dtype it has in the saving
package and cast to the target's dtype at restore. The port keeps float32
sums and int32 counts (int64 where its metric does) where the JAX package,
run with x64, keeps float64 and int64: integer and extremal leaves
round-trip exactly in both directions, float leaves within float32
rounding.

**Crash consistency** is the atomic-rename protocol: shards and manifest
are written and fsynced into a dot-prefixed temp directory, renamed into
place with one ``os.replace``, and only then does the ``LATEST`` pointer
move. A crash at any of the seven steps (:data:`CRASH_POINTS`, armed by
:func:`inject_crash` or by a fault plan's ``checkpoint.*`` seams) leaves
the previous complete snapshot restorable.

**The cut and the copy to the host.** A save cuts the state under the
metric's ingest lock: every bundle's logical rows (and the ledger's counts)
are packed on the device into one ``(num_tenants, row bytes)`` uint8 matrix,
a copy queued on the caller's stream behind the updates before it (a
compiled update writes the state in place, so references alone would not
hold the cut), and a CUDA event is recorded after it. Everything after runs
on the manager's side stream behind that event: the write marks compared
on the device and the moved-row mask read to the host (the delta's dirty
set), the dirty rows gathered by one ``index_select`` of the packed matrix,
and one copy into pinned host memory, each waited on by its own event. So
:meth:`CheckpointManager.save_async`, on the background engine's
``"durability"`` lane, overlaps the keyed updates that keep landing and adds
no synchronizing call to them; on the CPU the same steps run in place.
"""
import hashlib
import json
import os
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.durability.telemetry import (
    DURABILITY_STATS,
    observe_restore,
    observe_save,
    pin_tenant_traffic,
    unpin_tenant_traffic,
)
from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.resilience.faults import FaultInjected, maybe_fault
from metrics_tpu_torch.utilities.data import to_host

__all__ = [
    "CRASH_POINTS",
    "CheckpointCrash",
    "CheckpointError",
    "CheckpointManager",
    "inject_crash",
    "list_snapshots",
    "load_manifest",
    "merge_shard_states",
    "read_snapshot_state",
    "resolve_chain",
    "restore_checkpoint",
    "save_checkpoint",
    "write_snapshot",
]

#: manifest schema version (bumped on incompatible layout changes)
MANIFEST_SCHEMA = 1
MANIFEST_NAME = "MANIFEST.json"
LATEST_NAME = "LATEST"
#: the ledger pseudo-bundle: per-tenant routed-row counts ride the payload
#: so delta marks survive a restore (never a metric state leaf)
LEDGER_BUNDLE = "__ledger__"


class CheckpointError(RuntimeError):
    """A checkpoint operation failed (no restorable snapshot, layout
    mismatch, target too small)."""


class CheckpointCrash(RuntimeError):
    """Raised by the fault-injection hook to simulate a crash mid-save."""


#: armed crash points (fault-injection tests only; empty in production)
_CRASH_POINTS: set = set()

#: the protocol steps a save walks, in order — each is injectable
CRASH_POINTS = (
    "before_shard",
    "after_shard",
    "before_manifest",
    "after_manifest",
    "before_rename",
    "after_rename",
    "before_latest",
)


def _maybe_crash(point: str) -> None:
    if point in _CRASH_POINTS:
        raise CheckpointCrash(f"injected crash at {point!r}")
    # a FaultPlan spec armed at ``checkpoint.<point>`` (any raising mode)
    # kills the save where inject_crash would, as the protocol's own
    # CheckpointCrash
    try:
        maybe_fault(f"checkpoint.{point}")
    except FaultInjected as err:
        raise CheckpointCrash(f"injected crash at {point!r} ({err})") from err


@contextmanager
def inject_crash(point: str):
    """Arm one crash point for the duration of the block (the
    fault-injection tests' hook). Raises ``ValueError`` on an unknown
    point so a typo cannot silently test nothing."""
    if point not in CRASH_POINTS:
        raise ValueError(f"unknown crash point {point!r}; one of {CRASH_POINTS}")
    _CRASH_POINTS.add(point)
    try:
        yield
    finally:
        _CRASH_POINTS.discard(point)


# ---------------------------------------------------------------------------
# payload encoding (the packed-bundle byte contract, descriptors in JSON)
# ---------------------------------------------------------------------------


def _encode_payload(
    leaves: Sequence[Tuple[str, str, np.ndarray, Any]]
) -> Tuple[bytes, List[Dict[str, Any]]]:
    """Pack ``(bundle, name, array, reduction)`` leaves into one contiguous
    byte payload + the manifest layout rows describing each span."""
    parts: List[bytes] = []
    layout: List[Dict[str, Any]] = []
    offset = 0
    for bundle, name, arr, reduction in leaves:
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        layout.append(
            {
                "bundle": bundle,
                "name": name,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "reduction": reduction if isinstance(reduction, str) else None,
                "offset": offset,
                "nbytes": len(raw),
            }
        )
        parts.append(raw)
        offset += len(raw)
    return b"".join(parts), layout


def _decode_payload(
    payload: bytes, layout: Sequence[Dict[str, Any]]
) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`_encode_payload`: ``{bundle: {name: array}}``."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for row in layout:
        raw = payload[row["offset"] : row["offset"] + row["nbytes"]]
        arr = np.frombuffer(raw, dtype=np.dtype(row["dtype"])).reshape(row["shape"])
        out.setdefault(row["bundle"], {})[row["name"]] = arr.copy()
    return out


def merge_shard_states(
    shard_states: Sequence[Dict[str, Dict[str, np.ndarray]]],
    layout: Sequence[Dict[str, Any]],
) -> Dict[str, Dict[str, np.ndarray]]:
    """Re-reduce per-shard partial states into one state by each leaf's
    declared reduction — the restore-side analogue of the packed
    collectives: ``sum`` adds shard contributions, ``max``/``min`` fold
    elementwise (bit-identical for integer/extremal leaves), a leaf with no
    declared reduction takes the first shard's value."""
    if len(shard_states) == 1:
        return shard_states[0]
    reductions = {(r["bundle"], r["name"]): r.get("reduction") for r in layout}
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for bundle, leaves in shard_states[0].items():
        out[bundle] = {}
        for name, first in leaves.items():
            fx = reductions.get((bundle, name))
            acc = first.copy()
            for other in shard_states[1:]:
                contrib = other[bundle][name]
                if fx == "sum" or fx == "mean":
                    acc = acc + contrib
                elif fx == "max":
                    acc = np.maximum(acc, contrib)
                elif fx == "min":
                    acc = np.minimum(acc, contrib)
                # no declared reduction: first shard wins (replicated leaf)
            if fx == "mean":
                acc = acc / len(shard_states)
            out[bundle][name] = acc
    return out


# ---------------------------------------------------------------------------
# on-disk protocol
# ---------------------------------------------------------------------------


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_snapshot(
    directory: str,
    manifest: Dict[str, Any],
    shard_payloads: Sequence[bytes],
) -> Dict[str, Any]:
    """Write one snapshot atomically: shards + manifest into a temp dir,
    one ``os.replace`` into place, then the ``LATEST`` pointer. Returns the
    completed manifest. The caller provides ``manifest`` WITHOUT the
    ``shards`` section — checksums and byte counts are computed here so the
    manifest can never disagree with the bytes on disk."""
    name = manifest["name"]
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{name}")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        import shutil

        shutil.rmtree(tmp)
    os.makedirs(tmp)

    shards: List[Dict[str, Any]] = []
    _maybe_crash("before_shard")
    for i, payload in enumerate(shard_payloads):
        fn = f"shard-{i:05d}.bin"
        path = os.path.join(tmp, fn)
        with open(path, "wb") as fh:
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        shards.append(
            {
                "file": fn,
                "bytes": len(payload),
                "sha256": hashlib.sha256(payload).hexdigest(),
            }
        )
    _maybe_crash("after_shard")

    manifest = dict(manifest)
    manifest["shards"] = shards
    manifest["payload_bytes"] = int(sum(s["bytes"] for s in shards))
    manifest["complete"] = True
    _maybe_crash("before_manifest")
    mpath = os.path.join(tmp, MANIFEST_NAME)
    with open(mpath, "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.write("\n")
        fh.flush()
        os.fsync(fh.fileno())
    _maybe_crash("after_manifest")

    _maybe_crash("before_rename")
    os.replace(tmp, final)
    _fsync_dir(directory)
    _maybe_crash("after_rename")

    _maybe_crash("before_latest")
    latest_tmp = os.path.join(directory, f".{LATEST_NAME}.tmp")
    with open(latest_tmp, "w") as fh:
        fh.write(name + "\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(latest_tmp, os.path.join(directory, LATEST_NAME))
    _fsync_dir(directory)
    return manifest


def list_snapshots(directory: str) -> List[str]:
    """Snapshot directory names present on disk (complete or not),
    ascending; temp dirs and pointer files are invisible."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        d
        for d in os.listdir(directory)
        if d.startswith("snap-") and os.path.isdir(os.path.join(directory, d))
    )


def load_manifest(directory: str, name: str) -> Optional[Dict[str, Any]]:
    """The snapshot's manifest, checksum-verified against its shard files;
    ``None`` for anything torn, truncated, or tampered — an invalid
    snapshot simply does not exist as far as restore is concerned."""
    path = os.path.join(directory, name, MANIFEST_NAME)
    try:
        with open(path) as fh:
            manifest = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(manifest, dict) or not manifest.get("complete"):
        return None
    if manifest.get("schema") != MANIFEST_SCHEMA:
        return None
    for shard in manifest.get("shards", []):
        spath = os.path.join(directory, name, shard["file"])
        try:
            with open(spath, "rb") as fh:
                payload = fh.read()
        except OSError:
            return None
        if len(payload) != shard["bytes"]:
            return None
        if hashlib.sha256(payload).hexdigest() != shard["sha256"]:
            return None
    return manifest


def resolve_chain(directory: str) -> List[Dict[str, Any]]:
    """The newest restorable chain, full snapshot first: the latest valid
    snapshot whose whole parent ancestry validates. The ``LATEST`` pointer
    is consulted first; a stale/missing/torn pointer degrades to a scan.
    Returns ``[]`` when nothing restorable exists."""
    # newest-first scan: a crash between the snapshot rename and the LATEST
    # pointer update leaves the pointer one snapshot behind — the completed
    # (renamed) snapshot is restorable and must win, so the pointer is never
    # trusted over a newer on-disk candidate (it only serves tooling)
    ordered = list(reversed(list_snapshots(directory)))

    manifests: Dict[str, Optional[Dict[str, Any]]] = {}

    def valid(name: str) -> Optional[Dict[str, Any]]:
        if name not in manifests:
            manifests[name] = load_manifest(directory, name)
        return manifests[name]

    for head in ordered:
        chain: List[Dict[str, Any]] = []
        cursor: Optional[str] = head
        ok = True
        while cursor is not None:
            manifest = valid(cursor)
            if manifest is None:
                ok = False
                break
            chain.append(manifest)
            cursor = manifest.get("parent")
            if manifest["kind"] == "full":
                cursor = None
        if ok and chain and chain[-1]["kind"] == "full":
            return list(reversed(chain))
    return []


def read_snapshot_state(
    directory: str, manifest: Dict[str, Any]
) -> Dict[str, Dict[str, np.ndarray]]:
    """Decode one snapshot's payload into ``{bundle: {leaf: array}}``,
    re-reducing multi-shard payloads by the declared reductions."""
    shard_states = []
    for shard in manifest["shards"]:
        with open(os.path.join(directory, manifest["name"], shard["file"]), "rb") as fh:
            payload = fh.read()
        DURABILITY_STATS.inc("bytes_read", len(payload))
        shard_states.append(_decode_payload(payload, manifest["layout"]))
    return merge_shard_states(shard_states, manifest["layout"])


# ---------------------------------------------------------------------------
# the cut: one consistent copy of the state, packed per tenant row
# ---------------------------------------------------------------------------


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    try:
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError as err:
        raise CheckpointError(f"a {dtype} leaf has no numpy dtype, so it cannot be saved") from err


class _Cut:
    """One consistent cut of a metric's state: every leaf's rows packed into
    one uint8 matrix (``(num_tenants, row bytes)`` for a keyed metric, one
    row for a plain one), the column of each leaf, and the CUDA event after
    the packing copy (``None`` on the CPU)."""

    __slots__ = ("packed", "columns", "event", "keyed")

    def __init__(self, entries: List[Tuple[str, str, torch.Tensor, Any]], rows: Optional[int]) -> None:
        self.keyed = rows is not None
        self.columns: List[Tuple[str, str, np.dtype, Tuple[int, ...], int, int, Any]] = []
        parts: List[torch.Tensor] = []
        offset = 0
        device = torch.device("cpu")
        for bundle, name, leaf, reduction in entries:
            device = leaf.device
            np_dtype = _numpy_dtype(leaf.dtype)
            if self.keyed:
                flat, shape = leaf[:rows].reshape(rows, -1), tuple(leaf.shape[1:])
            else:
                flat, shape = leaf.reshape(1, -1), tuple(leaf.shape)
            raw = flat.contiguous().view(torch.uint8) if flat.shape[1] else flat.to(torch.uint8)
            self.columns.append((bundle, name, np_dtype, shape, offset, raw.shape[1], reduction))
            parts.append(raw)
            offset += raw.shape[1]
        n = rows if self.keyed else 1
        # the copy IS the cut: a compiled update writes the state in place
        self.packed = torch.cat(parts, dim=1) if parts else torch.empty((n, 0), dtype=torch.uint8, device=device)
        self.event = None
        if self.packed.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(self.packed.device))

    def leaves(self, host: np.ndarray) -> List[Tuple[str, str, np.ndarray, Any]]:
        """``(bundle, name, array, reduction)`` of every leaf, decoded from
        the host copy of (some rows of) the packed matrix."""
        out = []
        for bundle, name, np_dtype, shape, offset, nbytes, reduction in self.columns:
            raw = np.ascontiguousarray(host[:, offset:offset + nbytes]).view(np_dtype)
            arr = raw.reshape((host.shape[0],) + shape) if self.keyed else raw.reshape(shape)
            out.append((bundle, name, arr, reduction))
        return out


class _SideStream:
    """The device half of a save, on one side stream behind the cut's event:
    each read from the card goes to pinned memory and is waited on by an
    event, so the caller's stream, and the updates it carries, never wait."""

    def __init__(self) -> None:
        self._streams: Dict[torch.device, Any] = {}

    def _stream(self, device: torch.device) -> Any:
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return stream

    def to_host(self, device: torch.device, event: Any, fn: Any) -> np.ndarray:
        """``fn()`` (a tensor on ``device``, made on the side stream after
        ``event``) copied to the host; the CPU runs ``fn`` in place."""
        if event is None:
            return fn().numpy()
        stream = self._stream(device)
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            src = fn()
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return host.numpy()


def _device_ids(ids: np.ndarray, device: torch.device) -> torch.Tensor:
    ids = torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int64))
    if device.type == "cuda":
        return ids.pin_memory().to(device, non_blocking=True)
    return ids


def _unwrap(metric: Any) -> Tuple[Any, Optional[Any]]:
    """``(state-owning metric, scheduler-or-None)`` — accepts a bare
    metric/wrapper or a serving ``SLOScheduler`` (duck-typed: the scheduler
    owns the per-tenant write-generation ledger the delta marks prefer)."""
    if hasattr(metric, "tenant_generations") and hasattr(metric, "_metric"):
        return metric._metric, metric
    return metric, None


def _fault_back_all(metric: Any) -> None:
    hooks = getattr(metric, "__dict__", {}).get("_durability_hooks")
    if hooks is not None:
        hooks.before_snapshot()


def _is_collection(metric: Any) -> bool:
    return hasattr(metric, "_require_built") and hasattr(metric, "_keyed")


def _is_keyed(metric: Any) -> bool:
    return hasattr(metric, "num_tenants") and hasattr(metric, "_segment_scatter")


def _serial_lock(metric: Any):
    lock = getattr(metric, "_serial_lock", None)
    if callable(lock):
        return lock()
    return threading.RLock()


def _bundles(metric: Any) -> Dict[str, Any]:
    """``{bundle key: keyed-or-plain metric}`` — the state owners a
    snapshot serializes. List ("cat") states are refused: durable snapshots
    target fixed-shape mergeable states (use ``state_dict`` for unbounded
    accumulators)."""
    if _is_collection(metric):
        return dict(metric._require_built())
    owners = {"": metric}
    for name, value in metric._get_states().items():
        if isinstance(value, (list, tuple)):
            hint = getattr(metric, "_sketch_hint", None)
            raise CheckpointError(
                f"{type(metric).__name__} holds unbounded list state `{name}`;"
                " durable snapshots need fixed-shape mergeable states."
                + (f" {hint}" if hint else "")
            )
    return owners


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Own one metric's snapshot trail under ``directory``
    (``checkpoint.py:489``).

    ``metric`` is a :class:`~metrics_tpu_torch.wrappers.KeyedMetric`, a
    :class:`~metrics_tpu_torch.wrappers.MultiTenantCollection`, a plain
    :class:`~metrics_tpu_torch.Metric` with fixed-shape states, or a serving
    :class:`~metrics_tpu_torch.serving.SLOScheduler` (its metric is saved,
    and the delta marks ride its per-tenant write generations).

    ``history`` bounds the snapshots kept: after a completed full save,
    those older than the newest ``history`` are deleted (pruning happens only
    behind a full, so no delta's ancestry breaks).
    """

    def __init__(self, directory: str, metric: Any, *, history: Optional[int] = None):
        self.directory = str(directory)
        self._target, self._scheduler = _unwrap(metric)
        self.history = None if history is None else int(history)
        self._lock = threading.Lock()
        self._last_marks: Optional[Tuple[str, Any]] = None
        self._last_meta: Optional[Dict[str, Any]] = None
        self._side = _SideStream()
        existing = resolve_chain(self.directory)
        if existing:
            self._last_meta = {"name": existing[-1]["name"], "num_tenants": existing[-1].get("num_tenants")}
        self.telemetry_key = TELEMETRY.register(self)
        #: monotonic time of the last completed save (the auto-save interval's
        #: reference point)
        self._last_save_at = time.monotonic()
        self._auto_stop: Optional[threading.Event] = None
        self._auto_thread: Optional[threading.Thread] = None
        self._auto_future: Optional[Any] = None
        self._auto_failures = 0
        self._auto_saves = 0
        self._auto_skipped_inflight = 0
        # the delta marks read the traffic ledger: hold it open for the
        # manager's lifetime, so a telemetry toggle cannot freeze it
        if getattr(self._target, "_traffic", None) is not None:
            pin_tenant_traffic(self._target)
            self._traffic_unpin = weakref.finalize(self, unpin_tenant_traffic, self._target)

    # -- marks (the delta dirty-set source) ---------------------------------

    def _current_marks(self) -> Optional[Tuple[str, Any]]:
        """``("gen", {tenant: generation})`` from a scheduler, ``("rows",
        device counts)`` from a fed traffic ledger, else ``None`` (a save is
        then full: a ledger nothing feeds may be arbitrarily stale)."""
        if self._scheduler is not None:
            return ("gen", dict(self._scheduler.tenant_generations()))
        traffic = getattr(self._target, "_traffic", None)
        if traffic is not None and (TELEMETRY.enabled or self._target.__dict__.get("_durability_traffic_pin")):
            rows = traffic.marks()
            if rows is not None:
                return ("rows", rows)
        return None

    def _dirty_tenants(self, prev: Tuple[str, Any], cur: Tuple[str, Any], event: Any) -> Optional[np.ndarray]:
        """Tenants whose write marks moved between two cuts; ``None`` when the
        marks are incomparable (the save is then full). Routed-row counts are
        compared on the device and only the moved-row mask is read."""
        if prev[0] != cur[0]:
            return None
        if cur[0] == "gen":
            prev_map, cur_map = prev[1], cur[1]
            return np.asarray(sorted(t for t, g in cur_map.items() if g > prev_map.get(t, 0)), dtype=np.int64)
        prev_rows, cur_rows = prev[1], cur[1]
        if prev_rows.shape != cur_rows.shape:
            return None
        moved = self._side.to_host(cur_rows.device, event, lambda: cur_rows != prev_rows)
        return np.nonzero(moved)[0].astype(np.int64)

    # -- save ---------------------------------------------------------------

    def _next_name(self) -> str:
        seq = 0
        for name in list_snapshots(self.directory):
            try:
                seq = max(seq, int(name.split("-", 1)[1]))
            except (IndexError, ValueError):
                continue
        return f"snap-{seq + 1:08d}"

    def _snapshot_refs(self) -> Tuple[_Cut, Optional[Tuple[str, Any]], Dict[str, Any]]:
        """Under the metric's ingest lock: the cut (every bundle leaf's
        logical rows, and the ledger's counts, packed), the write marks and
        the keyed geometry; one consistent cut, even mid-soak."""
        metric = self._target
        with _serial_lock(metric):
            _fault_back_all(metric)
            bundles = _bundles(metric)
            marks = self._current_marks()
            meta: Dict[str, Any] = {"metric": type(metric).__name__}
            entries: List[Tuple[str, str, torch.Tensor, Any]] = []
            for key, owner in bundles.items():
                reductions = getattr(getattr(owner, "_child", owner), "_reductions", {})
                # leaves by name within a bundle: the JAX package's layout order
                for name, leaf in sorted(owner._get_states().items()):
                    entries.append((key, name, leaf, reductions.get(name)))
            rows = None
            if _is_keyed(metric) or _is_collection(metric):
                rows = int(metric.num_tenants)
                meta["keyed"] = True
                meta["num_tenants"] = rows
                meta["capacity"] = int(getattr(metric, "capacity", metric.num_tenants))
                ledger = marks[1] if marks is not None and marks[0] == "rows" else None
                if ledger is None and getattr(metric, "_traffic", None) is not None:
                    ledger = metric._traffic.marks()
                if ledger is not None:
                    entries.append((LEDGER_BUNDLE, "rows", ledger, None))
            else:
                meta["keyed"] = False
            cut = _Cut(entries, rows)
        return cut, marks, meta

    def save(self, *, delta: Optional[bool] = None) -> Dict[str, Any]:
        """Write one snapshot synchronously and return its manifest.

        ``delta=None`` (default) writes a delta when one is possible (a prior
        snapshot, comparable marks, the same keyed geometry) and a full
        snapshot otherwise; ``True`` forces a delta (raises when impossible),
        ``False`` a full."""
        cut, marks, meta = self._snapshot_refs()
        return self._write(cut, marks, meta, delta=delta)

    def save_async(self, *, delta: Optional[bool] = None) -> Any:
        """Cut the state now, on the caller's thread, and queue the rest of
        the save on the background engine's ``"durability"`` lane; returns
        its :class:`~metrics_tpu_torch.utilities.async_sync.SyncFuture`
        (resolving to the manifest). The copies to the host, the encoding and
        the disk writes overlap the updates that keep landing."""
        from metrics_tpu_torch.utilities.async_sync import get_engine

        cut, marks, meta = self._snapshot_refs()
        return get_engine("durability").submit(
            f"checkpoint:{self.telemetry_key}", lambda: self._write(cut, marks, meta, delta=delta)
        )

    # -- background auto-save policy ----------------------------------------

    def dirty_count(self) -> Optional[int]:
        """Tenants whose write marks moved since the last completed save
        (``None`` when unknowable: no marks source, no prior save, or
        incomparable marks — the cases a save resolves as a full)."""
        cur = self._current_marks()
        if cur is None:
            return None
        with self._lock:
            prev = self._last_marks
        if prev is None:
            # no marks baseline (first save predated any traffic): every
            # tenant with ANY write mark is dirty relative to that save
            if cur[0] == "rows":
                return int(to_host(torch.count_nonzero(cur[1])))
            return int(len(cur[1]))
        if cur[0] == "rows" and prev[0] == "rows" and prev[1].shape == cur[1].shape:
            return int(to_host(torch.count_nonzero(cur[1] != prev[1])))
        dirty = self._dirty_tenants(prev, cur, None)
        return None if dirty is None else int(len(dirty))

    def enable_auto_save(
        self,
        *,
        interval_s: Optional[float] = None,
        dirty_threshold: Optional[int] = None,
        delta: Optional[bool] = None,
        retry_policy: Optional[Any] = None,
        tick_s: Optional[float] = None,
    ) -> None:
        """Arm the background auto-save policy: a daemon thread triggers
        :meth:`save_async` on the durability lane whenever

        * ``interval_s`` elapsed since the last completed save, OR
        * at least ``dirty_threshold`` tenants' write marks moved since the
          last completed save (the delta dirty set — so the trigger scales
          with actual write pressure, not wall time)

        (either trigger alone is allowed; at least one is required). At
        most ONE auto save is in flight at a time — a tick that finds the
        previous save still writing skips (counted); a tick after a FAILED
        save backs off through ``retry_policy`` (default: the unified
        ``checkpoint`` plane policy,
        :func:`metrics_tpu_torch.resilience.policies.retry_policy_for`) — a
        crashed save never advances the marks, so the retry re-covers its
        dirty set by construction. Idempotent: re-enabling reconfigures."""
        if interval_s is None and dirty_threshold is None:
            raise ValueError("enable_auto_save needs interval_s and/or dirty_threshold")
        if interval_s is not None and float(interval_s) <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if dirty_threshold is not None and int(dirty_threshold) < 1:
            raise ValueError(f"dirty_threshold must be >= 1, got {dirty_threshold}")
        from metrics_tpu_torch.resilience.policies import retry_policy_for

        self.disable_auto_save()
        retry = retry_policy if retry_policy is not None else retry_policy_for("checkpoint")
        if tick_s is None:
            candidates = [0.25]
            if interval_s is not None:
                candidates.append(float(interval_s) / 4.0)
            tick_s = max(0.005, min(candidates))
        stop = threading.Event()
        self._auto_stop = stop
        self._auto_config = {
            "interval_s": None if interval_s is None else float(interval_s),
            "dirty_threshold": None if dirty_threshold is None else int(dirty_threshold),
            "delta": delta,
            "tick_s": float(tick_s),
        }

        def loop() -> None:
            backoff_until = 0.0
            while not stop.wait(tick_s):
                try:
                    # settle the previous save first: its outcome gates the
                    # single-flight and failure-backoff rules
                    future = self._auto_future
                    if future is not None:
                        if not future.done():
                            if self._auto_due():
                                self._auto_skipped_inflight += 1
                            continue
                        self._auto_future = None
                        if future.exception(timeout=0) is None:
                            self._auto_failures = 0
                        else:
                            # save_errors already counted by _write; the
                            # unified policy spaces the re-attempts
                            self._auto_failures += 1
                            backoff_until = time.monotonic() + retry.backoff(
                                self._auto_failures
                            )
                    if time.monotonic() < backoff_until or not self._auto_due():
                        continue
                    self._auto_saves += 1
                    DURABILITY_STATS.inc("auto_saves")
                    self._auto_future = self.save_async(delta=delta)
                except Exception:  # pragma: no cover - the policy must survive
                    self._auto_failures += 1
                    backoff_until = time.monotonic() + retry.backoff(self._auto_failures)

        self._auto_thread = threading.Thread(
            target=loop, name="metrics-tpu-auto-save", daemon=True
        )
        self._auto_thread.start()

    def _auto_due(self) -> bool:
        cfg = getattr(self, "_auto_config", None)
        if cfg is None:
            return False
        if cfg["interval_s"] is not None and (
            time.monotonic() - self._last_save_at >= cfg["interval_s"]
        ):
            return True
        if cfg["dirty_threshold"] is not None:
            dirty = self.dirty_count()
            # unknowable marks ask for a (full) save only when traffic is
            # possible at all — a plain metric with no ledger would
            # otherwise save every tick
            if dirty is not None and dirty >= cfg["dirty_threshold"]:
                return True
        return False

    def disable_auto_save(self, timeout: Optional[float] = 2.0) -> None:
        """Stop the auto-save thread (waits for it; an in-flight save
        finishes on the durability lane regardless). Idempotent."""
        stop, thread = self._auto_stop, self._auto_thread
        self._auto_stop = None
        self._auto_thread = None
        if stop is not None:
            stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout)

    def auto_save_report(self) -> Dict[str, Any]:
        """The auto-save policy's state: config, saves triggered, ticks
        skipped on an in-flight save, consecutive failures."""
        cfg = getattr(self, "_auto_config", None)
        return {
            "enabled": bool(self._auto_thread is not None and self._auto_thread.is_alive()),
            "config": dict(cfg) if cfg else None,
            "auto_saves": self._auto_saves,
            "skipped_in_flight": self._auto_skipped_inflight,
            "consecutive_failures": self._auto_failures,
            "dirty_count": self.dirty_count(),
        }

    def _write(
        self, cut: _Cut, marks: Optional[Tuple[str, Any]], meta: Dict[str, Any], *, delta: Optional[bool]
    ) -> Dict[str, Any]:
        start = time.perf_counter()
        with self._lock:
            kind = "full"
            dirty: Optional[np.ndarray] = None
            parent = self._last_meta["name"] if self._last_meta else None
            can_delta = (
                meta.get("keyed", False)
                and parent is not None
                and marks is not None
                and self._last_marks is not None
                and self._last_meta.get("num_tenants") == meta.get("num_tenants")
            )
            if can_delta:
                dirty = self._dirty_tenants(self._last_marks, marks, cut.event)
                if dirty is not None:
                    # a scheduler stamps the padding id -1 of a padded cohort too
                    dirty = dirty[(dirty >= 0) & (dirty < meta["num_tenants"])]
            if delta is True and (not can_delta or dirty is None):
                raise CheckpointError(
                    "delta save impossible: no comparable prior snapshot/marks"
                    " (geometry changed, first save, or no write ledger)"
                )
            if delta is not False and can_delta and dirty is not None:
                kind = "delta"
            try:
                packed = cut.packed
                if kind == "delta":
                    # the dirty rows of every leaf in one gather
                    ids = _device_ids(dirty, packed.device)
                    host = self._side.to_host(packed.device, cut.event, lambda: packed.index_select(0, ids))
                else:
                    host = self._side.to_host(packed.device, cut.event, lambda: packed)
                payload, layout = _encode_payload(cut.leaves(host))
                manifest = {
                    "schema": MANIFEST_SCHEMA,
                    "name": self._next_name(),
                    "kind": kind,
                    "parent": parent if kind == "delta" else None,
                    "created_unix_s": round(time.time(), 3),
                    "layout": layout,
                    "tenants": [int(t) for t in dirty] if kind == "delta" else None,
                    **meta,
                }
                manifest = write_snapshot(self.directory, manifest, [payload])
            except BaseException:
                DURABILITY_STATS.inc("save_errors")
                if EVENTS.enabled:
                    EVENTS.record("durability", self.telemetry_key, path="save_error", snapshot_kind=kind)
                raise
            # the marks advance only on a completed snapshot: a crashed save
            # leaves the dirty set whole for the retry
            self._last_marks = marks
            self._last_meta = {"name": manifest["name"], "num_tenants": meta.get("num_tenants")}
            self._last_save_at = time.monotonic()
            if kind == "full" and self.history is not None:
                self._prune(keep=self.history)

        dur = time.perf_counter() - start
        DURABILITY_STATS.inc("saves")
        if kind == "delta":
            DURABILITY_STATS.inc("delta_saves")
            DURABILITY_STATS.inc("tenants_stamped", int(len(dirty)))
        DURABILITY_STATS.inc("bytes_written", manifest["payload_bytes"])
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "saves")
            observe_save(dur, kind)
        if EVENTS.enabled:
            EVENTS.record(
                "durability",
                self.telemetry_key,
                dur_s=dur,
                t_start=start,
                path="save",
                snapshot_kind=kind,
                snapshot=manifest["name"],
                payload_bytes=manifest["payload_bytes"],
                tenants_stamped=(len(dirty) if kind == "delta" else None),
            )
        return manifest

    def _prune(self, keep: int) -> None:
        """Drop snapshots older than the newest ``keep`` (called only behind a
        completed full save, so no surviving delta's ancestry dangles)."""
        import shutil

        names = list_snapshots(self.directory)
        for name in names[: max(0, len(names) - keep)]:
            shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def restore(self, metric: Optional[Any] = None, *, transport: Optional[Any] = None) -> Any:
        """Restore the newest complete chain into ``metric`` (default: the
        managed metric) and return it (``checkpoint.py:917``).

        The host state is placed for the target: on the target's device
        (another device than the saving one is fine), through
        ``transport.place_state`` when a transport is given (a
        :class:`~metrics_tpu_torch.transport.sharded.ShardedTransport` shards
        the tenant axis). A keyed target needs ``num_tenants >=`` the saved
        logical count; its other rows stay at the defaults. Each leaf is cast
        to the target's dtype (see the module docstring). The restored
        tensors replace the target's, so a captured compiled update copies
        them into its graph before its next replay."""
        start = time.perf_counter()
        target = self._target if metric is None else _unwrap(metric)[0]
        chain = resolve_chain(self.directory)
        if not chain:
            DURABILITY_STATS.inc("restore_errors")
            raise CheckpointError(
                f"no restorable snapshot under {self.directory!r} (nothing"
                " complete, or every chain has a torn ancestor)"
            )
        state = read_snapshot_state(self.directory, chain[0])
        if chain[0].get("keyed") and LEDGER_BUNDLE not in state:
            # the full snapshot predates any routed row, a later delta may not
            state[LEDGER_BUNDLE] = {"rows": np.zeros(int(chain[0]["num_tenants"]), np.int64)}
        for manifest in chain[1:]:
            delta = read_snapshot_state(self.directory, manifest)
            ids = np.asarray(manifest["tenants"], dtype=np.int64)
            for bundle, leaves in delta.items():
                for name, rows in leaves.items():
                    state[bundle][name][ids] = rows
        marks: Optional[Tuple[str, Any]] = None
        with _serial_lock(target):
            self._install(target, chain[-1], state, transport)
            if target is self._target:
                # the marks baseline is cut with the install: an update in
                # between would escape the next delta's dirty set
                marks = self._current_marks()
        # the restore replaced whole bundles: re-note the memory ledger, out
        # of the serial lock (a pressure callback may evict, which takes it)
        from metrics_tpu_torch.observability.memory import LEDGER

        LEDGER.note(target)
        dur = time.perf_counter() - start
        DURABILITY_STATS.inc("restores")
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "restores")
            observe_restore(dur)
        if EVENTS.enabled:
            EVENTS.record(
                "durability", self.telemetry_key, dur_s=dur, t_start=start, path="restore",
                snapshot=chain[-1]["name"], chain=len(chain),
            )
        with self._lock:
            if target is self._target:
                self._last_marks = marks
                self._last_meta = {"name": chain[-1]["name"], "num_tenants": chain[-1].get("num_tenants")}
        return target

    def _install(
        self, target: Any, manifest: Dict[str, Any], state: Dict[str, Dict[str, np.ndarray]], transport: Optional[Any]
    ) -> None:
        ledger = state.pop(LEDGER_BUNDLE, None)
        saved_n = manifest.get("num_tenants")
        keyed = bool(manifest.get("keyed"))
        # one cut under the target's ingest lock, as the save's
        with _serial_lock(target):
            if _is_collection(target):
                owners = target._require_built()
                missing = set(state) - set(owners)
                if missing:
                    raise CheckpointError(
                        f"restore target collection lacks state bundles {sorted(missing)}"
                        " — build() it with the same members/groups as the saved one"
                    )
                targets = {k: owners[k] for k in state}
            else:
                if set(state) != {""}:
                    raise CheckpointError(
                        "snapshot holds a collection's bundles"
                        f" ({sorted(state)}); the restore target is a single metric"
                    )
                targets = {"": target}
            for bundle, owner in targets.items():
                leaves = state[bundle]
                if set(leaves) != set(owner._defaults):
                    raise CheckpointError(
                        f"snapshot leaves {sorted(leaves)} do not match the target's"
                        f" states {sorted(owner._defaults)} (bundle {bundle!r})"
                    )
                if keyed and owner.num_tenants < saved_n:
                    raise CheckpointError(
                        f"restore target has num_tenants={owner.num_tenants} <"
                        f" saved {saved_n}; grow() the target first"
                    )
                new_state: Dict[str, torch.Tensor] = {}
                for name, rows in leaves.items():
                    default = owner._defaults[name]
                    saved = torch.as_tensor(np.ascontiguousarray(rows)).to(device=default.device, dtype=default.dtype)
                    if keyed:
                        leaf = default.clone()
                        leaf[:saved_n] = saved
                    else:
                        leaf = saved.reshape(default.shape)
                    new_state[name] = leaf
                if transport is not None:
                    new_state = transport.place_state(new_state)
                owner._set_states(new_state)
                owner._computed = None
                owner._forward_cache = None
                owner._update_called = True
                # what the metric learns from data (Accuracy.mode) is decoded
                # from the restored states: a fresh target never saw a batch
                getattr(owner, "_child", owner)._restore_derived(leaves)
            traffic = getattr(target, "_traffic", None)
            if ledger is not None and traffic is not None and keyed:
                traffic.restore(ledger["rows"], target.device)
            # host rows a spiller still holds predate the restore: drop them
            hooks = getattr(target, "__dict__", {}).get("_durability_hooks")
            on_restore = getattr(hooks, "on_restore", None)
            if on_restore is not None:
                on_restore()

    # -- introspection ------------------------------------------------------

    def latest(self) -> Optional[str]:
        """Name of the newest restorable snapshot (``None`` when nothing
        restorable exists)."""
        chain = resolve_chain(self.directory)
        return chain[-1]["name"] if chain else None

    def report(self) -> Dict[str, Any]:
        chain = resolve_chain(self.directory)
        return {
            "directory": self.directory,
            "snapshots_on_disk": len(list_snapshots(self.directory)),
            "restorable_chain": [m["name"] for m in chain],
            "latest": chain[-1]["name"] if chain else None,
            "latest_kind": chain[-1]["kind"] if chain else None,
            "payload_bytes_latest": chain[-1]["payload_bytes"] if chain else None,
        }


def save_checkpoint(directory: str, metric: Any, **kwargs: Any) -> Dict[str, Any]:
    """One full snapshot of ``metric`` under ``directory`` (a throwaway
    :class:`CheckpointManager`; keep a manager for delta trails)."""
    return CheckpointManager(directory, metric).save(**kwargs)


def restore_checkpoint(directory: str, metric: Any, **kwargs: Any) -> Any:
    """Restore the newest complete chain under ``directory`` into
    ``metric`` and return it."""
    return CheckpointManager(directory, metric).restore(metric, **kwargs)
