"""Background async sync engine: epoch-end gathers off the step's path.

Counterpart of ``metrics_tpu/utilities/async_sync.py:73-637``. The eager
epoch sync (``Metric.compute()`` / ``MetricCollection.compute()``) is a
blocking descriptor + payload round trip; this module moves it onto a worker
thread:

* :meth:`Metric.compute_async` / :meth:`MetricCollection.compute_async`
  snapshot the live state into a detached shadow on the caller's thread and
  submit the shadow's ``compute()`` to the engine. The port's states are
  tensors a later ``update`` replaces but a caller could write into, so the
  snapshot is a real copy (``clone()``): on the card its copies are enqueued
  on the caller's stream, after the updates they snapshot, and the worker
  computes on the same legacy default stream. The returned
  :class:`SyncFuture` resolves to exactly what the synchronous ``compute()``
  would have returned at the snapshot, while later ``update``/``forward``
  calls go on.
* **Policies** (``on_degraded=``), applied to a round that raises or
  exceeds ``round_timeout_s``: ``"retry"`` (bounded exponential backoff
  through :class:`~metrics_tpu_torch.resilience.policies.RetryPolicy`),
  ``"stale"`` (serve the last completed generation, ``future.stale=True``),
  ``"quorum"`` (with degraded peers, the round narrowed to the healthy
  subgroup; a failed round retries like ``"retry"``).
* **Generation counter.** Every submission under one key gets the next
  generation; the engine keeps the latest completed ``(generation, value)``
  per key: what the stale policy serves and what keeps a late round from
  overwriting a newer result.

**Degraded peers** (``async_sync.py:156-197,366-456``). Before every
attempt the engine asks which peers are degraded: the processes the latest
published straggler report flags
(:func:`~metrics_tpu_torch.observability.tracing.degraded_processes`), with
the peers the resilience plane's membership epoch excludes (dead until an
explicit rejoin). A round started with degraded peers counts under
``degraded_rounds``; the ``"stale"`` policy then serves the last completed
generation without contacting them, and ``"quorum"`` runs the round over
the healthy subgroup (``quorum_syncs``): the active transport's
:meth:`~metrics_tpu_torch.transport.Transport.subgroup`, whose rounds span
only those ranks when a subgroup channel is registered, under
:class:`~metrics_tpu_torch.utilities.distributed.transport_overrides`
narrowing the decode. Every attempt consults the ``async.attempt`` fault
seam, runs its gathers under the ``"dcn"`` label, and feeds the failure
detector its outcome; every event carries the membership epoch.

Collective discipline holds across processes as for ``compute()``: every
process submits the same ``compute_async`` calls in the same order, which
the single FIFO worker keeps. Counters surface in
``observability.snapshot()["async_sync"]`` and the
``metrics_tpu_async_sync_*`` Prometheus family.
"""
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.observability.tracing import degraded_processes
from metrics_tpu_torch.resilience.detector import note_round_outcome
from metrics_tpu_torch.resilience.faults import maybe_fault
from metrics_tpu_torch.resilience.membership import current_epoch, dead_processes
from metrics_tpu_torch.resilience.policies import RetryPolicy, retry_policy_for

#: default bounded-backoff parameters of the "retry" policy
DEFAULT_MAX_RETRIES = 2
DEFAULT_BACKOFF_S = 0.05

#: the selectable policies
POLICIES = ("retry", "stale", "quorum")


class AsyncSyncError(RuntimeError):
    """A background sync exhausted its policy (retries spent, no stale
    generation to serve)."""


class SyncTimeout(AsyncSyncError):
    """A round exceeded its ``round_timeout_s``."""


def _degraded() -> List[int]:
    """Peers the engine treats as degraded before an attempt
    (``async_sync.py:156``): those the latest published straggler report
    flags, and those the membership epoch excludes (the hint can narrow the
    healthy set further, never resurrect a dead peer)."""
    return sorted({int(p) for p in degraded_processes()} | {int(p) for p in dead_processes()})


def _all_processes() -> List[int]:
    from metrics_tpu_torch.utilities.distributed import world_size

    return list(range(world_size()))


def _healthy_subgroup(degraded: List[int]) -> List[int]:
    """The world without ``degraded``; never empty."""
    everyone = _all_processes()
    healthy = [p for p in everyone if p not in set(degraded)]
    return healthy or everyone


def _note_round_outcome(peers: List[int], ok: bool) -> None:
    """Feed the failure detector one round's outcome (guarded: diagnostics
    must not break a sync)."""
    try:
        note_round_outcome(peers, ok)
    except Exception:  # pragma: no cover - diagnostics only
        pass


class SyncFuture:
    """Handle to one in-flight background sync.

    ``result(timeout=None)`` blocks until the engine resolves the job and
    returns the computed value (or raises the job's terminal error);
    ``done()`` polls. ``stale`` is True when the stale policy served the
    previous completed generation; ``generation`` is the submission's
    per-key generation; ``attempts`` counts the attempts the policy spent.
    """

    def __init__(self, key: str, generation: int, policy: str) -> None:
        self.key = key
        self.generation = generation
        self.policy = policy
        self.stale = False
        self.attempts = 0
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _wait(self, timeout: Optional[float]) -> None:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"background sync of {self.key} (generation {self.generation}) still in flight after {timeout}s"
            )

    def result(self, timeout: Optional[float] = None) -> Any:
        self._wait(timeout)
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        """The job's terminal error (None on success); blocks like :meth:`result`."""
        self._wait(timeout)
        return self._error

    def _resolve(self, value: Any, *, stale: bool = False) -> None:
        self._value = value
        self.stale = stale
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def __repr__(self) -> str:
        state = "done" if self.done() else "pending"
        return f"SyncFuture({self.key}, generation={self.generation}, policy={self.policy!r}, {state})"


class _Job:
    __slots__ = ("future", "thunk", "on_degraded", "round_timeout_s", "retry")

    def __init__(self, future, thunk, on_degraded, round_timeout_s, retry):
        self.future = future
        self.thunk = thunk
        self.on_degraded = on_degraded
        self.round_timeout_s = round_timeout_s
        self.retry = retry


class AsyncSyncEngine:
    """Single-worker FIFO engine running background sync jobs.

    One process-global instance (:func:`get_engine`) backs ``compute_async``
    and the serving scheduler; private instances serve tests. The worker
    thread starts on the first submission and is a daemon. FIFO keeps
    engine-issued collectives in the same order on every process.
    """

    def __init__(
        self,
        *,
        max_retries: int = DEFAULT_MAX_RETRIES,
        backoff_s: float = DEFAULT_BACKOFF_S,
        round_timeout_s: Optional[float] = None,
        retry_policy: Optional[RetryPolicy] = None,
    ) -> None:
        if retry_policy is None:
            retry_policy = retry_policy_for("async_sync").with_overrides(
                max_retries=int(max_retries), backoff_s=float(backoff_s)
            )
        self.retry_policy = retry_policy
        self.max_retries = int(retry_policy.max_retries)
        self.backoff_s = float(retry_policy.backoff_s)
        self.round_timeout_s = round_timeout_s
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[_Job] = []
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._in_flight = 0
        self._generations: Dict[str, int] = {}
        self._last: Dict[str, Any] = {}  # key -> (generation, value)
        self._pending: Dict[str, SyncFuture] = {}  # key -> newest unresolved future
        self._counters: Dict[str, int] = {
            "submitted": 0,
            "completed": 0,
            "failed": 0,
            "retries": 0,
            "timeouts": 0,
            "stale_serves": 0,
            "quorum_syncs": 0,
            "degraded_rounds": 0,
            "coalesced": 0,
        }

    # -- submission ---------------------------------------------------------

    def submit(
        self,
        key: str,
        thunk: Callable[[], Any],
        *,
        on_degraded: str = "retry",
        round_timeout_s: Optional[float] = None,
        max_retries: Optional[int] = None,
        backoff_s: Optional[float] = None,
        coalesce: bool = False,
    ) -> SyncFuture:
        """Queue ``thunk`` (a self-contained sync + compute over a detached
        snapshot) and return its :class:`SyncFuture`; per-job
        ``round_timeout_s``/``max_retries``/``backoff_s`` override the
        engine's. ``coalesce=True`` returns the pending future of ``key``
        when a job for it is queued or running (counted ``coalesced``, no new
        generation): for single-process reads only, since it makes the
        number of submissions depend on local timing."""
        if on_degraded not in POLICIES:
            raise ValueError(f"on_degraded must be one of {POLICIES}, got {on_degraded!r}")
        with self._lock:
            if coalesce:
                pending = self._pending.get(key)
                if pending is not None and not pending.done():
                    self._counters["coalesced"] += 1
                    return pending
            generation = self._generations.get(key, 0) + 1
            self._generations[key] = generation
            future = SyncFuture(key, generation, on_degraded)
            self._pending[key] = future
            self._queue.append(
                _Job(
                    future,
                    thunk,
                    on_degraded,
                    self.round_timeout_s if round_timeout_s is None else round_timeout_s,
                    self.retry_policy.with_overrides(max_retries=max_retries, backoff_s=backoff_s),
                )
            )
            self._counters["submitted"] += 1
            self._in_flight += 1
            if self._thread is None or not self._thread.is_alive():
                self._stopping = False
                self._thread = threading.Thread(target=self._worker, name="metrics-tpu-async-sync", daemon=True)
                self._thread.start()
            self._cv.notify()
        return future

    # -- the worker ---------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopping:
                    self._cv.wait()
                if self._stopping and not self._queue:
                    return
                job = self._queue.pop(0)
            try:
                self._run_job(job)
            finally:
                with self._lock:
                    self._in_flight -= 1
                    # the coalesce window closes with the job
                    if self._pending.get(job.future.key) is job.future:
                        del self._pending[job.future.key]

    def _attempt(self, thunk: Callable[[], Any], timeout: Optional[float]) -> Any:
        """One attempt under the per-round timeout: the thunk runs on a
        helper thread that is abandoned on expiry (a hung round can only be
        orphaned; it works on the job's detached snapshot, so its late
        completion changes nothing the caller sees). The helper inherits
        the worker's transport and transport overrides."""
        if timeout is None:
            return thunk()
        from metrics_tpu_torch.transport import get_transport, use_transport
        from metrics_tpu_torch.utilities.distributed import applied_transport_overrides, current_transport_overrides

        box: Dict[str, Any] = {}
        transport = get_transport()
        overrides = current_transport_overrides()

        def run() -> None:
            try:
                with use_transport(transport), applied_transport_overrides(overrides):
                    box["value"] = thunk()
            except BaseException as err:  # noqa: BLE001 - relayed to the policy
                box["error"] = err

        helper = threading.Thread(target=run, daemon=True)
        helper.start()
        helper.join(timeout)
        if helper.is_alive():
            with self._lock:
                self._counters["timeouts"] += 1
            raise SyncTimeout(f"transport round exceeded round_timeout_s={timeout}")
        if "error" in box:
            raise box["error"]
        return box["value"]

    def _serve_stale(self, job: _Job, reason: str) -> bool:
        """Resolve the job from the last completed generation; False when
        none has completed for the key."""
        with self._lock:
            last = self._last.get(job.future.key)
            if last is None:
                return False
            self._counters["stale_serves"] += 1
            self._counters["completed"] += 1
        generation, value = last
        job.future._resolve(value, stale=True)
        self._record_event(job, outcome="stale", reason=reason, served_generation=generation)
        return True

    def _run_job(self, job: _Job) -> None:
        from metrics_tpu_torch.transport import resolve_transport, use_transport
        from metrics_tpu_torch.utilities.distributed import transport_overrides

        future = job.future
        attempt = 0
        while True:
            degraded = _degraded()
            quorum: Optional[List[int]] = None
            if degraded:
                with self._lock:
                    self._counters["degraded_rounds"] += 1
                if job.on_degraded == "stale" and self._serve_stale(job, reason=f"degraded peers {degraded}"):
                    return
                if job.on_degraded == "quorum":
                    quorum = _healthy_subgroup(degraded)
            try:
                future.attempts = attempt + 1
                maybe_fault("async.attempt", key=future.key, attempt=attempt + 1)
                if quorum is not None:
                    with self._lock:
                        self._counters["quorum_syncs"] += 1
                    # a true subgroup where the transport can form one; the
                    # decode narrows either way
                    with use_transport(resolve_transport().subgroup(quorum)), transport_overrides(
                            quorum=quorum, transport_label="dcn"):
                        value = self._attempt(job.thunk, job.round_timeout_s)
                else:
                    with transport_overrides(transport_label="dcn"):
                        value = self._attempt(job.thunk, job.round_timeout_s)
            except BaseException as err:  # noqa: BLE001 - the policy decides
                _note_round_outcome(degraded, ok=False)
                reason = f"{type(err).__name__}: {err}"
                if job.on_degraded == "stale" and self._serve_stale(job, reason=reason):
                    return
                if job.on_degraded in ("retry", "quorum") and job.retry.should_retry(attempt + 1):
                    attempt += 1
                    with self._lock:
                        self._counters["retries"] += 1
                    job.retry.sleep(attempt)
                    continue
                with self._lock:
                    self._counters["failed"] += 1
                if isinstance(err, AsyncSyncError):
                    future._fail(err)
                else:
                    future._fail(
                        AsyncSyncError(f"background sync of {future.key} failed after {attempt + 1} attempt(s): {reason}")
                    )
                self._record_event(job, outcome="failed", reason=reason)
                return
            with self._lock:
                self._counters["completed"] += 1
                prev = self._last.get(future.key)
                # a late round never overwrites a newer completed generation
                if prev is None or prev[0] < future.generation:
                    self._last[future.key] = (future.generation, value)
            # a completed round is a heartbeat of every peer it spanned
            _note_round_outcome(quorum if quorum is not None else _all_processes(), ok=True)
            future._resolve(value)
            self._record_event(job, outcome="quorum" if quorum is not None else "completed", quorum=quorum)
            return

    def _record_event(self, job: _Job, *, outcome: str, **payload: Any) -> None:
        """One ``sync`` event per finished job, stamped with the membership
        epoch."""
        if EVENTS.enabled:
            EVENTS.record(
                "sync",
                job.future.key,
                path="async",
                policy=job.on_degraded,
                outcome=outcome,
                generation=job.future.generation,
                attempts=job.future.attempts,
                stale=job.future.stale,
                membership_epoch=current_epoch(),
                **{k: v for k, v in payload.items() if v is not None},
            )

    # -- reading / lifecycle ------------------------------------------------

    def last_generation(self, key: str) -> int:
        """The latest completed generation of ``key`` (0 when none)."""
        with self._lock:
            last = self._last.get(key)
            return last[0] if last else 0

    def summary(self) -> Dict[str, Any]:
        """Compact JSON view for ``snapshot()["async_sync"]``."""
        with self._lock:
            return {
                "engine_alive": bool(self._thread is not None and self._thread.is_alive()),
                "in_flight": self._in_flight,
                "generations": dict(self._generations),
                **self._counters,
            }

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued job has finished; False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._in_flight == 0:
                    return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.001)

    def reset(self) -> None:
        """Clear counters, generations and retained values (queued jobs keep
        running); across processes, reset on every process or on none."""
        with self._lock:
            self._generations.clear()
            self._last.clear()
            self._pending.clear()
            for k in self._counters:
                self._counters[k] = 0

    def shutdown(self, timeout: Optional[float] = 1.0) -> None:
        """Stop the worker once its queue drains."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout)


#: the process-global engine, made on first use (importing starts no thread)
_ENGINE: Optional[AsyncSyncEngine] = None
_ENGINE_LOCK = threading.Lock()
#: named engines (lanes): host-only work that must not queue behind the
#: default lane's FIFO
_NAMED_ENGINES: Dict[str, AsyncSyncEngine] = {}


def get_engine(name: str = "default") -> AsyncSyncEngine:
    """The process-global engine of lane ``name``, made on first use.
    ``"default"`` is the lane ``compute_async`` and the serving scheduler
    share (its FIFO is the cross-process order); any other name is a
    single-worker lane of its own, for host-only work."""
    global _ENGINE
    with _ENGINE_LOCK:
        if name != "default":
            engine = _NAMED_ENGINES.get(name)
            if engine is None:
                engine = _NAMED_ENGINES[name] = AsyncSyncEngine()
            return engine
        if _ENGINE is None:
            _ENGINE = AsyncSyncEngine()
        return _ENGINE


def staging_lane() -> AsyncSyncEngine:
    """The admission queue's staging lane: the staged prefetch fills and
    transfers the next cohort there, never behind the default lane's
    refreshes."""
    return get_engine("staging")


def compute_async(obj: Any, **policy: Any) -> SyncFuture:
    """``obj.compute()`` at this moment, on the default engine: the body of
    ``Metric.compute_async`` and ``MetricCollection.compute_async``. ``obj``
    is cloned here, on the caller's thread; each attempt computes its own
    clone of that snapshot (a timed-out attempt is orphaned, not cancelled,
    and must not race the retry). ``policy`` takes ``on_degraded``,
    ``round_timeout_s``, ``max_retries`` and ``backoff_s``."""
    if TELEMETRY.enabled:
        TELEMETRY.inc(obj.telemetry_key, "compute_async_calls")
    shadow = obj.clone()
    return get_engine().submit(obj.telemetry_key, lambda: shadow.clone().compute(), **policy)


def summary() -> Dict[str, Any]:
    """The default engine's view, ``{}`` when nothing was ever submitted."""
    if _ENGINE is None:
        return {}
    return _ENGINE.summary()
