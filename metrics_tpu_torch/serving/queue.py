"""Admission queue: many-threaded event ingest coalesced into keyed updates.

Counterpart of ``metrics_tpu/serving/queue.py``. The keyed wrappers want few,
large updates; a service's ingest side is many threads submitting single
event rows. :class:`AdmissionQueue` is the seam between the two:

* **submit side** — any number of producer threads call
  :meth:`AdmissionQueue.submit` (one event row: a tenant id and the metric's
  positional update arguments for that row) or :meth:`submit_many` (a
  cohort). Admission is host-side Python under one condition variable; the
  :mod:`policy <metrics_tpu_torch.serving.policy>` decides what happens at
  capacity, and every shed row is exactly accounted.
* **dispatch side** — a single flusher thread coalesces pending rows into
  ONE ``target(tenant_ids, *stacked_args)`` call (``KeyedMetric.update`` or
  ``MultiTenantCollection.update``: one segment-scatter pass, kernels B3 and
  B4 on the card) when ``max_batch`` rows are resident or the oldest has
  waited ``max_delay_ms``, whichever comes first. Dispatches are serialized
  on one lock, so a manual :meth:`flush` or a scheduler read never
  interleaves with the flusher.

**Where the cohort goes.** ``device=`` names where each cohort is copied
before ``target(...)``; by default the bound target's owner's ``.device``
(``target.__self__.device``), else the port's default ``"cuda"``, which
raises without a card. The target receives host numpy views
(:class:`~metrics_tpu_torch.serving.staging.StagedColumn`) carrying their
copy on that device (``device_tensor``): the keyed wrappers dispatch the
copy and read the host view for the id check and the traffic ledger.
Unstaged, a cohort is ``np.stack``-ed into pageable memory, so each
column's copy to the card waits for the card (one synchronizing call per
column, as the JAX package's unstaged dispatch converts in its target).
With ``staging=True`` (:mod:`metrics_tpu_torch.serving.staging`) submit
writes rows into a columnar ring, cohort formation is a slice hand-off into
a pinned slot, and the copy is ``non_blocking`` on the queue's own side
CUDA stream; the dispatch's stream waits on the copy's event, and a
prefetched second slot overlaps cohort ``k + 1``'s staging with cohort
``k``'s dispatch. A copy that fails raises into the flush's exact
accounting (``dispatch_error``); nothing falls back to the host.

Exact accounting is load-bearing: ``admitted − shed == dispatched (+
resident)`` holds at every quiescent point whether telemetry is on or off.
The flusher dispatches on the legacy default stream, which every thread
shares, so its updates order after the callers' work.

The sampled dispatch profiler (``observability/profiling.py``) brackets the
flush-side work of each flush (``"serving_flush"``) and each staged
cohort's fill and copy (``"serving_stage"``), as the reference does
(``queue.py:587,651,725,780,958``). ``quarantine="auto"`` follows the health
policy: it scans whenever ``set_health_policy`` is not ``"off"``. Each
dispatch consults the resilience plane's ``serving.dispatch`` fault seam
first (``queue.py:640,962``): an injected error lands in the flush's exact
accounting as any failed dispatch does.
"""
import inspect
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.health import get_health_policy
from metrics_tpu_torch.observability.profiling import PROFILER
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.observability.tracing import TRACER
from metrics_tpu_torch.resilience.faults import maybe_fault
from metrics_tpu_torch.serving.policy import AdmissionPolicy, resolve_policy
from metrics_tpu_torch.serving.staging import (
    StagedCohort,
    StagingRing,
    StagingSlot,
    StagingSlotPool,
    as_staged,
    stage_layout,
)
from metrics_tpu_torch.serving.telemetry import (
    SERVING_STATS,
    observe_dispatch_latency,
    observe_flush,
    observe_ingest,
    observe_queue_depth,
    observe_queue_wait,
    observe_staging_fill,
    observe_staging_occupancy,
    observe_staging_overlap,
)
from metrics_tpu_torch.utilities.data import resolve_device
from metrics_tpu_torch.utilities.prints import rank_zero_warn

__all__ = ["AdmissionQueue", "QueueClosedError"]

#: default micro-batch size (rows per coalesced dispatch)
DEFAULT_MAX_BATCH = 4096
#: default flush deadline: a row waits at most this long before dispatch
DEFAULT_MAX_DELAY_MS = 5.0
#: retained poisoned rows (the COUNT is exact regardless)
DEAD_LETTER_CAP = 32
#: distinct submit-cohort ids carried on one dispatch span's payload
SPAN_COHORT_CAP = 64


class QueueClosedError(RuntimeError):
    """Submission against a closed queue."""


class AdmissionQueue:
    """Coalesce per-tenant event submissions into keyed update dispatches.

    Args:
        target: ``target(tenant_ids, *cols)``, each argument a ``(rows, ...)``
            host view carrying its device copy; typically
            ``KeyedMetric.update`` or ``MultiTenantCollection.update``.
        max_batch: flush when this many rows are resident.
        max_delay_ms: flush when the OLDEST resident row has waited this long.
        capacity_rows: admission bound (default ``8 * max_batch``).
        policy: ``"block"`` / ``"shed_oldest"`` / ``"shed_tenant_over_quota"``
            or an :class:`~metrics_tpu_torch.serving.policy.AdmissionPolicy`.
        block_timeout_s: bound on a blocked producer's wait (``block``).
        tenant_quota_rows: resident-row quota per tenant
            (``shed_tenant_over_quota``; default ``capacity_rows // 8``).
        pad_to_bucket: pad every cohort to the next power-of-two row count
            (capped at ``max_batch``) with discard rows (id ``-1``, zeroed
            columns), which a ``validate_ids=False`` keyed target drops and
            counts under ``invalid_tenant_ids``. B3/B4 take any row count; a
            compiled step caching one graph per count would want at most
            ``log2(max_batch) + 1`` of them.
        quarantine: ``"on"`` sheds every row with a NaN/Inf float value under
            the exact reason ``"poisoned"`` (counted as dead letters, a
            bounded sample kept in :meth:`dead_letters`) and dispatches the
            rest; ``"off"`` never scans; ``"auto"`` (default) scans whenever
            the health policy (``observability.set_health_policy``) is not
            ``"off"``: the switch that arms the state guard arms the
            ingest-side quarantine.
        breaker: optional
            :class:`~metrics_tpu_torch.resilience.policies.CircuitBreaker`
            fronting the dispatch: while open, cohorts shed at once under
            ``"breaker_open"``; a half-open probe closes it on success.
        staging: device-resident ingest through a staging ring and a pool
            of pinned slots (see :mod:`metrics_tpu_torch.serving.staging`).
        staging_slots: slot-pool depth (>= 2; 2 double-buffers).
        staging_transfer: copy staged cohorts to ``device`` ahead of the
            dispatch; ``False`` hands the target owning numpy copies.
        device: where cohorts are copied (see the module docstring).
        start: start the flusher thread now (``False``: flush by hand).
    """

    def __init__(
        self,
        target: Callable[..., Any],
        *,
        max_batch: int = DEFAULT_MAX_BATCH,
        max_delay_ms: float = DEFAULT_MAX_DELAY_MS,
        capacity_rows: Optional[int] = None,
        policy: Any = "block",
        block_timeout_s: Optional[float] = None,
        tenant_quota_rows: Optional[int] = None,
        pad_to_bucket: bool = False,
        quarantine: str = "auto",
        breaker: Optional[Any] = None,
        staging: bool = False,
        staging_slots: int = 2,
        staging_transfer: bool = True,
        device: Optional[Union[str, torch.device]] = None,
        start: bool = True,
    ) -> None:
        if not callable(target):
            raise TypeError(f"target must be callable, got {target!r}")
        if quarantine not in ("auto", "on", "off"):
            raise ValueError(f"quarantine must be 'auto', 'on' or 'off', got {quarantine!r}")
        self.quarantine = quarantine
        self.breaker = breaker
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if float(max_delay_ms) <= 0:
            raise ValueError(f"max_delay_ms must be > 0, got {max_delay_ms}")
        self._target = target
        if device is None:
            # a metric's update is wrapped: its owner sits behind __wrapped__
            owner = getattr(inspect.unwrap(target), "__self__", None)
            device = getattr(owner, "device", None) or "cuda"
        self.device = resolve_device(device)
        self.pad_to_bucket = bool(pad_to_bucket)
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.capacity_rows = int(capacity_rows) if capacity_rows is not None else 8 * self.max_batch
        if self.capacity_rows < self.max_batch:
            raise ValueError(
                f"capacity_rows ({self.capacity_rows}) must be >= max_batch"
                f" ({self.max_batch}) or no size-triggered flush can ever fill"
            )
        if isinstance(policy, AdmissionPolicy):
            self.policy = resolve_policy(policy)
        else:
            knobs: Dict[str, Any] = {}
            if block_timeout_s is not None:
                knobs["block_timeout_s"] = block_timeout_s
            if tenant_quota_rows is not None:
                knobs["tenant_quota_rows"] = tenant_quota_rows
            self.policy = resolve_policy(policy, **knobs)
        if self.policy.name == "shed_tenant_over_quota" and self.policy.tenant_quota_rows is None:
            self.policy = AdmissionPolicy("shed_tenant_over_quota", tenant_quota_rows=max(1, self.capacity_rows // 8))

        self._cv = threading.Condition()
        #: resident rows, oldest first: (tenant, args, t_submit, cohort);
        #: under staging the second element is the row's ring sequence
        #: (pending sequences are always one contiguous range)
        self._pending: List[Tuple[int, Any, float, Optional[str]]] = []
        self._per_tenant: Dict[int, int] = {}
        self._closed = False
        self._flush_now = False
        self._flusher: Optional[threading.Thread] = None
        #: serializes every target() call (metric updates are not reentrant)
        self._dispatch_lock = threading.Lock()
        self._in_dispatch = 0
        self._last_error: Optional[BaseException] = None
        self._error_warned = False
        # the exact ledger, independent of telemetry
        self._submitted = 0
        self._admitted = 0
        self._shed = 0
        self._shed_by_reason: Dict[str, int] = {}
        self._dispatched = 0
        self._flushes = 0
        self._dead_letters: deque = deque(maxlen=DEAD_LETTER_CAP)
        #: newest successful dispatch span id (the scheduler stamps it on its cache)
        self._last_dispatch_span: Optional[str] = None
        # -- device-resident ingest -----------------------------------------
        self.staging = bool(staging)
        self.staging_transfer = bool(staging_transfer)
        self._ring: Optional[StagingRing] = None
        self._slots: Optional[StagingSlotPool] = None
        if self.staging:
            # resident rows plus every popped-but-uncopied cohort (a slot is
            # taken BEFORE the pop: at most slots * max_batch such rows)
            self._ring = StagingRing(self.capacity_rows + int(staging_slots) * self.max_batch)
            self._slots = StagingSlotPool(int(staging_slots), self.max_batch, pin=self.device.type == "cuda")
        #: the side stream the staged copies run on (made on first use)
        self._copy_stream: Optional[Any] = None
        #: the prefetched cohort (at most one; keeps ``_in_dispatch`` raised)
        self._staged_next: Optional[Dict[str, Any]] = None
        #: (start, end) of the newest dispatch, for the overlap ledger
        self._last_dispatch_window: Optional[Tuple[float, float]] = None
        self._stage_seconds = 0.0
        self._prefetched_stage_seconds = 0.0
        self._overlap_seconds = 0.0
        self._staged_cohorts = 0
        self._prefetched_cohorts = 0
        self.telemetry_key = TELEMETRY.register(self)
        SERVING_STATS.register_queue(self)
        if start:
            self._ensure_flusher()

    # ------------------------------------------------------------------
    # submit side
    # ------------------------------------------------------------------

    def submit(self, tenant_id: int, *args: Any) -> bool:
        """Admit one event row; ``True`` when admitted, ``False`` when the
        policy shed it. Thread-safe; raises :class:`QueueClosedError` after
        :meth:`close`."""
        return self.submit_many([tenant_id], *[[a] for a in args]) == 1

    def submit_many(self, tenant_ids: Any, *cols: Any) -> int:
        """Admit a cohort of rows (``tenant_ids`` and one equal-length
        column per update argument, host arrays); returns how many rows were
        admitted. Rows are admitted one by one, so a partial shed is possible
        (and exactly counted)."""
        ids = np.asarray(tenant_ids).reshape(-1)
        ncols = [np.asarray(c) for c in cols]
        for c in ncols:
            if c.shape[:1] != ids.shape:
                raise ValueError(f"every column must carry one entry per row: ids {ids.shape} vs column {c.shape}")
        n = int(ids.shape[0])
        if n == 0:
            return 0
        # one submit span per cohort; its id rides every admitted row
        span = TRACER.begin("serving", group=self.telemetry_key, bucket="submit")
        cohort = span.span_id if span is not None else None
        now = time.perf_counter()
        admitted = 0
        shed: Dict[str, int] = {}
        with self._cv:
            if self._closed:
                TRACER.end(span, rows=n, error="queue_closed")
                raise QueueClosedError("AdmissionQueue is closed")
            if self.staging:
                # the schema check raises before any accounting
                self._ensure_staging_layout_locked(ncols)
            self._note_submitted(n)
            if self.staging:
                admitted, shed = self._submit_staged_locked(ids, ncols, now, cohort)
            else:
                for i in range(n):
                    row = (int(ids[i]), tuple(c[i] for c in ncols), now, cohort)
                    reason = self._admission_decision_locked(row[0])
                    if reason is None:
                        self._append_locked(row)
                        admitted += 1
                    else:
                        shed[reason] = shed.get(reason, 0) + 1
            self._cv.notify_all()
        if shed:
            self._account_shed(shed)
        TRACER.end(span, rows=n, admitted=admitted, shed=n - admitted)
        return admitted

    def _note_submitted(self, n: int) -> None:
        self._submitted += n  # caller holds the cv
        SERVING_STATS.inc("submitted_rows", n)
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "submitted_rows", n)

    def _ensure_staging_layout_locked(self, ncols: List[np.ndarray]) -> None:
        """Bind (or check) the ring and slot layout for this cohort's column
        schema; a change is accepted only with no live row."""
        layout = stage_layout(ncols)
        if self._ring.layout == layout:
            return
        if self._ring.layout is not None and (self._pending or self._in_dispatch or self._staged_next is not None):
            raise ValueError(
                "staged submit column schema changed while rows are live —"
                f" ring layout {self._ring.layout} vs cohort {layout}. Drain"
                " the queue before submitting a different argument schema,"
                " or run with staging=False for heterogeneous cohorts."
            )
        self._ring.bind(layout)
        self._slots.bind(layout)

    def _submit_staged_locked(
        self, ids: np.ndarray, ncols: List[np.ndarray], now: float, cohort: Optional[str]
    ) -> Tuple[int, Dict[str, int]]:
        """The staged admission loop (caller holds the cv): the policy decides
        row by row; the data lands in the ring in one bulk columnar write when
        the policy never releases the lock (every policy but ``block``), row
        by row otherwise (a ``block`` wait lets a flush pop rows admitted
        earlier in this very cohort)."""
        ring = self._ring
        can_defer = self.policy.name != "block"
        admitted = 0
        first_seq: Optional[int] = None
        adm_idx: List[int] = []
        shed: Dict[str, int] = {}
        for i in range(int(ids.shape[0])):
            tenant = int(ids[i])
            reason = self._admission_decision_locked(tenant)
            if reason is not None:
                shed[reason] = shed.get(reason, 0) + 1
                continue
            seq = ring.alloc()
            if first_seq is None:
                first_seq = seq
            self._append_locked((tenant, seq, now, cohort))
            if can_defer:
                adm_idx.append(i)
            else:
                ring.write_row(seq, tenant, now, cohort, [c[i] for c in ncols])
            admitted += 1
        if can_defer and admitted:
            # sequences are contiguous (the cv was never dropped)
            if admitted == ids.shape[0]:
                ring.write_rows(first_seq, ids.astype(np.int32, copy=False), now, cohort, ncols)
            else:
                sel = np.asarray(adm_idx, dtype=np.intp)
                ring.write_rows(first_seq, ids[sel].astype(np.int32, copy=False), now, cohort, [c[sel] for c in ncols])
        return admitted, shed

    def _admission_decision_locked(self, tenant: int) -> Optional[str]:
        """The policy's verdict for one row (caller holds the cv): ``None``
        admits, else the exact shed reason. ``shed_oldest`` evictions and
        ``block`` waits happen here."""
        policy = self.policy
        if policy.name == "shed_tenant_over_quota":
            if self._per_tenant.get(tenant, 0) >= policy.tenant_quota_rows:
                return "tenant_over_quota"
            if len(self._pending) >= self.capacity_rows:
                return "queue_full"
        elif policy.name == "shed_oldest":
            while len(self._pending) >= self.capacity_rows:
                old = self._pending.pop(0)
                self._per_tenant[old[0]] -= 1
                # an eviction is counted here, row by row
                self._shed += 1
                self._shed_by_reason["shed_oldest"] = self._shed_by_reason.get("shed_oldest", 0) + 1
                SERVING_STATS.shed("shed_oldest", 1)
        elif policy.name == "block":
            deadline = None if policy.block_timeout_s is None else time.perf_counter() + policy.block_timeout_s
            while len(self._pending) >= self.capacity_rows and not self._closed:
                remaining = None if deadline is None else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    return "block_timeout"
                self._cv.wait(remaining)
            if self._closed:
                return "block_timeout"
        return None

    def _append_locked(self, row: Tuple[int, Any, float, Optional[str]]) -> None:
        """Bookkeeping of one admitted row (caller holds the cv)."""
        self._pending.append(row)
        self._per_tenant[row[0]] = self._per_tenant.get(row[0], 0) + 1
        self._admitted += 1
        SERVING_STATS.inc("admitted_rows")
        # wake the flusher at the first resident row (the deadline clock
        # starts) and at a full batch: a producer about to block in this
        # cohort would otherwise sleep beside an unnotified flusher
        n_pending = len(self._pending)
        if n_pending == 1 or n_pending >= self.max_batch:
            self._cv.notify_all()

    def _account_shed(self, shed: Dict[str, int]) -> None:
        with self._cv:
            for reason, n in shed.items():
                self._shed += n
                self._shed_by_reason[reason] = self._shed_by_reason.get(reason, 0) + n
        for reason, n in shed.items():
            SERVING_STATS.shed(reason, n)
            if TELEMETRY.enabled:
                TELEMETRY.inc(self.telemetry_key, f"shed_{reason}", n)
        if EVENTS.enabled:
            EVENTS.record(
                "serving", self.telemetry_key, path="shed", policy=self.policy.name,
                **{f"shed_{r}": n for r, n in shed.items()},
            )

    # ------------------------------------------------------------------
    # dispatch side
    # ------------------------------------------------------------------

    def _ensure_flusher(self) -> None:
        if self._flusher is None or not self._flusher.is_alive():
            self._flusher = threading.Thread(target=self._flusher_loop, name="metrics-tpu-serving-flusher", daemon=True)
            self._flusher.start()

    def _flusher_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed and self._staged_next is None:
                    self._cv.wait()
                if self._closed and not self._pending and self._staged_next is None:
                    return
                if self._pending:
                    deadline = self._pending[0][2] + self.max_delay_s
                    while (
                        len(self._pending) < self.max_batch
                        and self._pending
                        and not self._closed
                        and not self._flush_now
                        # a prefetched cohort waits: do not sit out a deadline on top of it
                        and self._staged_next is None
                    ):
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                if not self._pending and self._staged_next is None:
                    continue
                trigger = "size" if len(self._pending) >= self.max_batch else ("close" if self._closed else "deadline")
            self._flush_once(trigger)

    def _twins(self, host: List[np.ndarray]) -> List[torch.Tensor]:
        """Copies of host columns on ``device``. From pageable memory each
        copy to the card waits for the card (the unstaged path)."""
        return [torch.from_numpy(h).to(self.device) for h in host]

    def _flush_once(self, trigger: str) -> int:
        """Pop up to ``max_batch`` oldest rows and dispatch them as ONE
        target call; returns rows popped (0 when nothing was resident)."""
        if self.staging:
            return self._flush_once_staged(trigger)
        with self._dispatch_lock:
            with self._cv:
                if not self._pending:
                    return 0
                depth_before = len(self._pending)
                rows = self._pending[: self.max_batch]
                del self._pending[: self.max_batch]
                if not self._pending:
                    self._flush_now = False
                for tenant, _, _, _ in rows:
                    left = self._per_tenant.get(tenant, 0) - 1
                    if left > 0:
                        self._per_tenant[tenant] = left
                    else:
                        self._per_tenant.pop(tenant, None)
                self._in_dispatch += 1
                self._cv.notify_all()  # room freed: wake blocked producers
            popped = len(rows)
            # the sampled bracket spans the whole flush-side host work: cohort
            # formation, the quarantine scan, the pad and the target's submit
            prof = PROFILER.begin("serving_flush", self.device)
            try:
                t0 = time.perf_counter()
                ids = np.asarray([r[0] for r in rows], dtype=np.int32)
                ncols = len(rows[0][1])
                cols = [np.stack([r[1][j] for r in rows]) for j in range(ncols)]
                # quarantine: one NaN/Inf row would corrupt every float "sum"
                # state its flush touches; such rows shed as "poisoned"
                if self._quarantine_active():
                    mask: Optional[np.ndarray] = None
                    for c in cols:
                        if np.issubdtype(c.dtype, np.floating):
                            bad = ~np.isfinite(c).reshape(popped, -1).all(axis=1)
                            mask = bad if mask is None else (mask | bad)
                    if mask is not None and mask.any():
                        keep = np.nonzero(~mask)[0]
                        bad_rows = [rows[i] for i in np.nonzero(mask)[0]]
                        self._shed_rows(
                            "poisoned", len(bad_rows),
                            dead_letter_samples=[(r[0], r[1]) for r in bad_rows[-DEAD_LETTER_CAP:]],
                        )
                        rows = [rows[i] for i in keep]
                        ids = ids[~mask]
                        cols = [c[~mask] for c in cols]
                # an open breaker sheds the cohort without a doomed dispatch
                if rows and self.breaker is not None and not self.breaker.allow():
                    self._shed_rows("breaker_open", len(rows))
                    rows = []
                error: Optional[BaseException] = None
                if rows:
                    if self.pad_to_bucket and len(rows) < self.max_batch:
                        bucket = min(1 << max(0, len(rows) - 1).bit_length(), self.max_batch)
                        pad = bucket - len(rows)
                        if pad > 0:
                            ids = np.concatenate([ids, np.full(pad, -1, ids.dtype)])
                            cols = [np.concatenate([c, np.zeros((pad,) + c.shape[1:], c.dtype)]) for c in cols]
                    try:
                        maybe_fault("serving.dispatch", rows=len(rows))
                        host = [ids] + cols
                        staged = [as_staged(h, d) for h, d in zip(host, self._twins(host))]
                        self._target(*staged)
                        if self.breaker is not None:
                            self.breaker.record_success()
                    except Exception as err:  # noqa: BLE001 - accounted below
                        error = err
                        if self.breaker is not None:
                            self.breaker.record_failure()
                if prof is not None:
                    PROFILER.finish(prof, self.telemetry_key)
                    prof = None
                end = time.perf_counter()
                kept = rows
                self._note_flush(
                    trigger,
                    len(kept),
                    lambda: (np.fromiter((r[2] for r in kept), np.float64, len(kept)), [r[3] for r in kept]),
                    depth_before,
                    end - t0,
                    end,
                    error,
                )
            finally:
                if prof is not None:  # formation raised: close the bracket
                    PROFILER.finish(prof, self.telemetry_key)
                with self._cv:
                    self._in_dispatch -= 1
                    self._cv.notify_all()
        return popped

    # ------------------------------------------------------------------
    # staged dispatch side (staging=True)
    # ------------------------------------------------------------------

    def _staged_next_rows_locked(self) -> int:
        """Rows parked in the prefetched cohort (caller holds the cv): they
        left ``_pending`` but are resident in the ledger's sense until the
        flush that consumes them dispatches or sheds them."""
        entry = self._staged_next
        return int(entry["n"]) if entry is not None else 0

    def _pop_staged_locked(self, slot: StagingSlot) -> Optional[Tuple[StagingSlot, int, int]]:
        """Pop up to ``max_batch`` rows off the staged pending window into
        ``slot`` (caller holds the cv): ``(slot, n, depth_before)``, or
        ``None``. The rows are copied out of the ring here, under the
        admission lock: once popped they are no longer resident, so a
        ``shed_oldest`` producer may wrap the ring over them, and a copy
        made later (the JAX package stages the copy on the lane,
        ``queue.py:726``) can read rows admitted after them in their place."""
        if not self._pending:
            return None
        depth_before = len(self._pending)
        take = min(depth_before, self.max_batch)
        seq0 = self._pending[0][1]
        # the first submit's bind may have raced the slot's acquire
        slot = self._slots.refresh(slot)
        self._ring.copy_out(seq0, take, slot)
        del self._pending[:take]
        if not self._pending:
            self._flush_now = False
        # the popped ids are exactly the ring span [seq0, seq0 + take)
        uniq, counts = np.unique(self._ring.read_ids(seq0, take), return_counts=True)
        for tenant, cnt in zip(uniq.tolist(), counts.tolist()):
            left = self._per_tenant.get(tenant, 0) - int(cnt)
            if left > 0:
                self._per_tenant[tenant] = left
            else:
                self._per_tenant.pop(tenant, None)
        self._in_dispatch += 1
        self._cv.notify_all()  # room freed: wake blocked producers
        return slot, take, depth_before

    def _take_slot(self, blocking: bool) -> Optional[StagingSlot]:
        """A free slot whose last copy to the card has finished, so its
        pinned buffer may be refilled; ``None`` when none is free and
        ``blocking`` is off."""
        slot = self._slots.acquire() if blocking else self._slots.try_acquire()
        if slot is not None:
            slot.wait_copied()
        return slot

    def _stage_cohort(self, slot: StagingSlot, n: int) -> StagedCohort:
        """Stage the ``n`` rows popped into ``slot``: the vectorized
        quarantine scan, the power-of-two pad folded in place, and the copy
        to the device. Runs on the staging lane (prefetch) or the flushing
        thread; touches only the slot."""
        t0 = time.perf_counter()
        copy_stream = None
        if self.device.type == "cuda" and self.staging_transfer:
            copy_stream = self._side_stream()
        prof = PROFILER.begin("serving_stage", self.device if copy_stream is not None else None, copy_stream)
        m = n
        if self._quarantine_active():
            mask: Optional[np.ndarray] = None
            for buf in slot.cols:
                if np.issubdtype(buf.dtype, np.floating):
                    bad = ~np.isfinite(buf[:n]).reshape(n, -1).all(axis=1)
                    mask = bad if mask is None else (mask | bad)
            if mask is not None and mask.any():
                bad_idx = np.nonzero(mask)[0]
                samples = [
                    (int(slot.ids[i]), tuple(np.copy(buf[i]) for buf in slot.cols)) for i in bad_idx[-DEAD_LETTER_CAP:]
                ]
                self._shed_rows("poisoned", int(bad_idx.shape[0]), dead_letter_samples=samples)
                keep = ~mask
                m = int(keep.sum())
                # fancy indexing copies first, so the overlapping store is safe
                slot.ids[:m] = slot.ids[:n][keep]
                slot.t_submit[:m] = slot.t_submit[:n][keep]
                slot.cohorts[:m] = slot.cohorts[:n][keep]
                for buf in slot.cols:
                    buf[:m] = buf[:n][keep]
        bucket = m
        if m and self.pad_to_bucket and m < self.max_batch:
            bucket = min(1 << max(0, m - 1).bit_length(), self.max_batch)
            if bucket > m:
                slot.ids[m:bucket] = -1
                for buf in slot.cols:
                    buf[m:bucket] = 0
        ids_view: np.ndarray = slot.ids[:bucket]
        col_views: List[np.ndarray] = [buf[:bucket] for buf in slot.cols]
        fill_end = time.perf_counter()
        if prof is not None:
            prof.mark_device_start()  # the device half is the copy alone
        event = None
        if m and self.staging_transfer:
            twins, event = self._transfer_cohort(slot, bucket)
            ids_view = as_staged(ids_view, twins[0])
            col_views = [as_staged(v, d) for v, d in zip(col_views, twins[1:])]
        elif m:
            # no device copy: hand the target OWNING host copies, since the
            # slot is reused once the dispatch returns
            ids_view = np.array(ids_view)
            col_views = [np.array(v) for v in col_views]
        if prof is not None:
            # host half: the slot fill; device half: the copy to the card
            PROFILER.finish(prof, self.telemetry_key, submit_end=fill_end)
        return StagedCohort(
            slot, m, bucket, ids_view, col_views, slot.t_submit[:m], slot.cohorts[:m], (t0, time.perf_counter()), event
        )

    def _transfer_cohort(self, slot: StagingSlot, bucket: int) -> Tuple[List[torch.Tensor], Optional[Any]]:
        """The cohort's ``bucket`` leading rows on ``device`` (ids first):
        on a card, ``non_blocking`` copies from the slot's pinned tensors on
        the queue's side stream, and the event that ends them (also kept on
        the slot, which is not refilled before it); on the CPU, owning
        clones. A failed copy raises."""
        if self.device.type != "cuda":
            return [torch.from_numpy(slot.ids[:bucket]).clone()] + [
                torch.from_numpy(buf[:bucket]).clone() for buf in slot.cols
            ], None
        with torch.cuda.stream(self._side_stream()):
            twins = [t[:bucket].to(self.device, non_blocking=True) for t in slot.tensors]
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        slot.event = event
        return twins, event

    def _side_stream(self) -> Any:
        """The queue's side CUDA stream for cohort copies (made at first use)."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        return self._copy_stream

    def _submit_stage_job(self, slot: StagingSlot, n: int) -> Any:
        from metrics_tpu_torch.utilities.async_sync import staging_lane

        return staging_lane().submit(
            f"{self.telemetry_key}.stage",
            lambda: self._stage_cohort(slot, n),
            max_retries=0,  # a re-run would double-count quarantine sheds
        )

    def _maybe_prefetch(self) -> None:
        """Double-buffer: when a FULL cohort is already resident, pop it now
        and stage it on the ``staging`` lane, so its fill and copy run under
        the dispatch this flush is about to start. Popping only at
        ``max_batch`` keeps the batching exactly as it was: these rows would
        flush on the ``size`` trigger at once anyway."""
        with self._cv:
            if self._staged_next is not None or self._closed or len(self._pending) < self.max_batch:
                return
        slot = self._take_slot(blocking=False)
        if slot is None:
            return
        entry: Optional[Dict[str, Any]] = None
        with self._cv:
            if self._staged_next is None and len(self._pending) >= self.max_batch:
                popped = self._pop_staged_locked(slot)
                if popped is not None:
                    slot, n, depth_before = popped
                    entry = {"slot": slot, "n": n, "depth_before": depth_before, "trigger": "size"}
        if entry is None:
            self._slots.release(slot)
            return
        entry["future"] = self._submit_stage_job(slot, entry["n"])
        with self._cv:
            self._staged_next = entry
            self._cv.notify_all()

    def _note_staged(self, cohort: StagedCohort, prefetched: bool, prev_window: Optional[Tuple[float, float]]) -> None:
        """The overlap ledger: a prefetched cohort's stage window intersected
        with the dispatch that ran while it staged."""
        s0, s1 = cohort.stage_window
        stage_s = max(0.0, s1 - s0)
        overlap = 0.0
        if prefetched and prev_window is not None:
            d0, d1 = prev_window
            overlap = max(0.0, min(s1, d1) - max(s0, d0))
        with self._cv:
            self._staged_cohorts += 1
            self._stage_seconds += stage_s
            if prefetched:
                self._prefetched_cohorts += 1
                self._prefetched_stage_seconds += stage_s
                self._overlap_seconds += overlap
        SERVING_STATS.inc("staged_cohorts")
        if prefetched:
            SERVING_STATS.inc("prefetched_cohorts")
        if TELEMETRY.enabled:
            observe_staging_fill(stage_s)
            if prefetched:
                observe_staging_overlap(overlap)
            observe_staging_occupancy(self._slots.in_use())

    def _dispatch_staged(self, cohort: StagedCohort) -> None:
        """``target(...)`` of a staged cohort; on a card the current stream
        first waits on the cohort's copy event (a device-side wait: the host
        goes on), and the copies are marked in use on it."""
        if cohort.event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(cohort.event)
            for col in (cohort.ids, *cohort.cols):
                col.device_tensor.record_stream(current)
        self._target(cohort.ids, *cohort.cols)

    def _flush_once_staged(self, trigger: str) -> int:
        """The staged flush: take the prefetched cohort when one waits, else
        stage now; kick the NEXT cohort's prefetch; dispatch."""
        with self._dispatch_lock:
            entry: Optional[Dict[str, Any]] = None
            with self._cv:
                if self._staged_next is not None:
                    entry = self._staged_next
                    self._staged_next = None
            prefetched = entry is not None
            if entry is None:
                slot = self._take_slot(blocking=True)
                with self._cv:
                    popped = self._pop_staged_locked(slot)
                if popped is None:
                    self._slots.release(slot)
                    return 0
                slot, n, depth_before = popped
                entry = {"slot": slot, "n": n, "depth_before": depth_before, "trigger": trigger}
            popped_n = int(entry["n"])
            depth_before = int(entry["depth_before"])
            trigger = entry["trigger"]
            prev_window = self._last_dispatch_window
            cohort: Optional[StagedCohort] = None
            try:
                t0 = time.perf_counter()
                error: Optional[BaseException] = None
                try:
                    future = entry.get("future")
                    if future is not None:
                        cohort = future.result()
                    else:
                        cohort = self._stage_cohort(entry["slot"], entry["n"])
                except Exception as err:  # noqa: BLE001 - accounted below
                    error = err
                # kick the next cohort's stage BEFORE dispatching this one
                self._maybe_prefetch()
                if cohort is not None:
                    self._note_staged(cohort, prefetched, prev_window)
                rows_n = cohort.n if cohort is not None else 0
                if rows_n and self.breaker is not None and not self.breaker.allow():
                    self._shed_rows("breaker_open", rows_n)
                    rows_n = 0
                if rows_n:
                    prof = PROFILER.begin("serving_flush", self.device)
                    try:
                        maybe_fault("serving.dispatch", rows=rows_n)
                        self._dispatch_staged(cohort)
                        if self.breaker is not None:
                            self.breaker.record_success()
                    except Exception as err:  # noqa: BLE001 - accounted below
                        error = err
                        if self.breaker is not None:
                            self.breaker.record_failure()
                    finally:
                        if prof is not None:
                            PROFILER.finish(prof, self.telemetry_key)
                end = time.perf_counter()
                self._last_dispatch_window = (t0, end)
                if cohort is None or not rows_n:
                    # the stage failed (the popped span sheds as a dispatch
                    # error), or every row was shed before the dispatch
                    self._note_flush(
                        trigger, popped_n if cohort is None else 0, lambda: (np.empty(0), ()), depth_before,
                        end - t0, end, error,
                    )
                else:
                    self._note_flush(
                        trigger, rows_n, lambda: (cohort.t_submits, cohort.cohorts), depth_before, end - t0, end, error
                    )
            finally:
                self._slots.release(entry["slot"])
                with self._cv:
                    self._in_dispatch -= 1
                    self._cv.notify_all()
        return popped_n

    def _quarantine_active(self) -> bool:
        """``"on"`` scans, ``"off"`` does not; ``"auto"`` scans whenever the
        health policy is armed (``queue.py:1008``)."""
        if self.quarantine == "auto":
            return get_health_policy() != "off"
        return self.quarantine == "on"

    def _shed_rows(
        self, reason: str, n: int, *, dead_letter_samples: Optional[List[Tuple[int, Tuple]]] = None
    ) -> None:
        """Shed ``n`` admitted rows at dispatch time under ``reason``
        (quarantine, open breaker): each moves from resident to shed, so the
        conservation laws hold. ``dead_letter_samples`` is the bounded sample
        of ``(tenant, args)`` kept for inspection."""
        if n == 0:
            return
        with self._cv:
            self._shed += n
            self._shed_by_reason[reason] = self._shed_by_reason.get(reason, 0) + n
            if dead_letter_samples:
                self._dead_letters.extend(dead_letter_samples)
        SERVING_STATS.shed(reason, n)
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, f"shed_{reason}", n)
        if EVENTS.enabled:
            EVENTS.record("serving", self.telemetry_key, path="shed", policy=self.policy.name, **{f"shed_{reason}": n})

    def dead_letters(self) -> List[Tuple[int, Tuple]]:
        """The kept sample of quarantined ``(tenant_id, args)`` rows (newest
        last, at most ``DEAD_LETTER_CAP``); the exact total is
        ``stats()["shed_by_reason"]["poisoned"]``."""
        with self._cv:
            return list(self._dead_letters)

    def _note_flush(
        self,
        trigger: str,
        n: int,
        row_meta: Callable[[], Tuple[np.ndarray, Sequence[Optional[str]]]],
        depth_before: int,
        dur: float,
        end: float,
        error: Optional[BaseException],
    ) -> None:
        """Ledger and telemetry of one flush of ``n`` rows; ``row_meta``
        gives the dispatched rows' submit times (an array) and trace cohorts,
        and is called only under the telemetry and tracer gates. The three
        per-row histograms are observed in bulk: at 4096 rows, row by row
        they cost tens of ms of host time per flush."""
        with self._cv:
            self._flushes += 1
            if error is None:
                self._dispatched += n
            else:
                # a failed dispatch ingested nothing: its rows count as shed
                self._shed += n
                self._shed_by_reason["dispatch_error"] = self._shed_by_reason.get("dispatch_error", 0) + n
                self._last_error = error
        if error is not None:
            SERVING_STATS.inc("dispatch_errors")
            SERVING_STATS.shed("dispatch_error", n)
            if not self._error_warned:
                self._error_warned = True
                rank_zero_warn(
                    f"AdmissionQueue dispatch failed ({type(error).__name__}:"
                    f" {error}); the cohort's {n} rows are counted shed under"
                    " reason 'dispatch_error'. Subsequent failures are counted"
                    " silently — watch serving.dispatch_errors.",
                    UserWarning,
                )
        SERVING_STATS.flush(trigger, n if error is None else 0, depth_before)
        t_start = end - dur
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "flushes")
            if error is None:
                TELEMETRY.inc(self.telemetry_key, "dispatched_rows", n)
            observe_flush(dur, trigger)
            observe_queue_depth(depth_before)
            t_submits, _ = row_meta()
            observe_ingest(end - t_submits, self.policy.name)
            observe_queue_wait(np.maximum(0.0, t_start - t_submits), self.policy.name)
            observe_dispatch_latency(np.full(len(t_submits), dur), self.policy.name)
        if n and TRACER.enabled:
            # the wait (oldest submit to flush start) and dispatch (flush
            # start to return) spans, recorded after the fact from endpoints
            # stamped on the perf_counter clock
            pc_now = time.perf_counter()
            t_submits, row_cohorts = row_meta()
            oldest_submit = float(t_submits.min()) if len(t_submits) else None
            # distinct cohorts in admission order
            cohorts = list(dict.fromkeys(c for c in row_cohorts if c is not None))
            dropped_cohorts = max(0, len(cohorts) - SPAN_COHORT_CAP)
            cohorts = cohorts[:SPAN_COHORT_CAP]
            if oldest_submit is not None:
                TRACER.record_span(
                    "serving", group=self.telemetry_key, bucket="wait",
                    enter_ago_s=pc_now - oldest_submit, exit_ago_s=pc_now - t_start, rows=n, trigger=trigger,
                )
            dispatch_span = TRACER.record_span(
                "serving",
                group=self.telemetry_key,
                bucket="dispatch",
                enter_ago_s=pc_now - t_start,
                exit_ago_s=pc_now - end,
                rows=n,
                trigger=trigger,
                cohorts=cohorts,
                dropped_cohorts=dropped_cohorts,
                error=(f"{type(error).__name__}: {error}" if error else None),
            )
            if error is None and dispatch_span is not None:
                with self._cv:
                    self._last_dispatch_span = dispatch_span
        if EVENTS.enabled:
            EVENTS.record(
                "serving",
                self.telemetry_key,
                dur_s=dur,
                t_start=t_start,
                path="flush",
                trigger=trigger,
                rows=n,
                depth_before=depth_before,
                policy=self.policy.name,
                error=(f"{type(error).__name__}: {error}" if error else None),
            )

    # ------------------------------------------------------------------
    # control plane
    # ------------------------------------------------------------------

    def flush(self) -> int:
        """Dispatch everything resident NOW on the caller's thread
        (``manual`` trigger); returns rows dispatched or shed."""
        total = 0
        while True:
            n = self._flush_once("manual")
            if n == 0:
                return total
            total += n

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until no row is resident and no dispatch is in flight;
        ``False`` on timeout. A live flusher is asked to flush at once;
        without one (``start=False``) the residue is dispatched on the
        caller's thread. ``timeout`` bounds the whole drain."""
        if self._flusher is None or not self._flusher.is_alive():
            self.flush()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._flush_now = bool(self._pending)
            self._cv.notify_all()
            while self._pending or self._in_dispatch:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Stop admitting, flush the residue, and join the flusher."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self.flush()
        thread = self._flusher
        if thread is not None and thread.is_alive():
            thread.join(timeout)

    def depth(self) -> int:
        """Rows resident now; a prefetched cohort parked in a slot counts."""
        with self._cv:
            return len(self._pending) + self._staged_next_rows_locked()

    def last_dispatch_span(self) -> Optional[str]:
        """The newest successful dispatch span id (``None`` before the first
        traced flush)."""
        with self._cv:
            return self._last_dispatch_span

    def stats(self) -> Dict[str, Any]:
        """The queue's exact ledger: submitted, admitted, shed (by reason),
        dispatched, flushes, resident.

        Two conservation laws hold at every quiescent point:

        * ``admitted == dispatched + resident + shed(shed_oldest) +
          shed(dispatch_error) + shed(poisoned) + shed(breaker_open)``;
        * ``submitted − shed(total) == dispatched + resident``, so at drain
          ``submitted − shed`` is exactly what the keyed state ingested
          (``tenant_report()["rows_routed"]``)."""
        with self._cv:
            staging_block: Dict[str, Any] = {"enabled": self.staging}
            if self.staging:
                staging_block.update(
                    {
                        "slots": self._slots.num_slots,
                        "ring_capacity": self._ring.capacity,
                        "transfer": self.staging_transfer,
                        "staged_cohorts": self._staged_cohorts,
                        "prefetched_cohorts": self._prefetched_cohorts,
                        "stage_seconds": self._stage_seconds,
                        "overlap_seconds": self._overlap_seconds,
                        "overlap_fraction": (
                            self._overlap_seconds / self._prefetched_stage_seconds
                            if self._prefetched_stage_seconds > 0
                            else 0.0
                        ),
                    }
                )
            return {
                "policy": self.policy.name,
                "max_batch": self.max_batch,
                "max_delay_ms": round(self.max_delay_s * 1e3, 6),
                "capacity_rows": self.capacity_rows,
                "staging": staging_block,
                "submitted": self._submitted,
                "admitted": self._admitted,
                "shed": self._shed,
                "shed_by_reason": dict(self._shed_by_reason),
                "dispatched": self._dispatched,
                "flushes": self._flushes,
                "resident": len(self._pending) + self._staged_next_rows_locked(),
                "dead_letter_rows": self._shed_by_reason.get("poisoned", 0),
                "closed": self._closed,
                "last_error": (
                    f"{type(self._last_error).__name__}: {self._last_error}" if self._last_error else None
                ),
            }
