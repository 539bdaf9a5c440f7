"""SLO-aware scheduling between update dispatch and epoch reads.

Counterpart of ``metrics_tpu/serving/scheduler.py``. A serving loop has two
consumers of the keyed state: the **write path** (admission-queue flushes,
one keyed update each) and the **read path** (per-tenant ``compute()``
values for dashboards, far dearer than one update). :class:`SLOScheduler`
owns both and arbitrates by the **staleness SLO**:

* **updates always win the dispatch path.** Flushes run on the queue's
  flusher thread; a read never blocks them: it clones the state on the
  caller's thread (on the card the clone's copies are enqueued on the
  caller's stream, after the updates it snapshots) and computes the clone
  on the background engine
  (:func:`~metrics_tpu_torch.utilities.async_sync.get_engine`).
* **reads are served from a result cache** keyed by the **write
  generation**, bumped once per dispatched flush, and tracked per tenant
  (each flush stamps only the tenants it touched, read from the cohort's
  host view), so a tenant-scoped read is served from the cache while none
  of its tenants changed (``tenant_cache_hits``). A cache entry younger than
  the read's ``max_staleness_s`` is served at once (``stale_serves``) while
  a refresh runs behind it; otherwise the read flushes the queue
  (read-your-writes), submits a refresh and waits for it.
  ``max_staleness_s=0`` never serves a value older than the requested
  tenants' latest write.
* **refreshes coalesce**: concurrent stale reads share one in-flight
  refresh (``coalesced_refreshes``).

A read selects its tenants on the device the values lie on and copies the
selection to the host (one copy per member); it never reads a whole tensor
off the card to index it.

The resilience plane's membership epoch is a cache-invalidation edge like a
write generation (``scheduler.py:59-66,253-260``): each cache entry carries
the epoch it computed under, and a read under another epoch treats it as
expired. The per-tenant generation ledger is pruned of tenants past the
metric's current count after an elastic shrink
(:meth:`SLOScheduler.prune_tenant_generations`), and it is the checkpoint
plane's preferred delta dirty-set source
(:meth:`SLOScheduler.tenant_generations`).
"""
import copy
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.observability.tracing import TRACER
from metrics_tpu_torch.serving.queue import AdmissionQueue
from metrics_tpu_torch.serving.telemetry import SERVING_STATS, observe_read_staleness
from metrics_tpu_torch.utilities.async_sync import get_engine
from metrics_tpu_torch.utilities.data import to_host

__all__ = ["SLOScheduler"]



def _membership_epoch() -> int:
    """The resilience plane's current membership epoch (0 while idle)."""
    from metrics_tpu_torch.resilience.membership import current_epoch

    return current_epoch()


#: default read staleness budget (seconds)
DEFAULT_MAX_STALENESS_S = 1.0
#: default bound on a blocking (cache-miss) read
DEFAULT_READ_TIMEOUT_S = 30.0


class SLOScheduler:
    """Serve one keyed metric: queued updates in, SLO-governed reads out.

    Args:
        metric: a :class:`~metrics_tpu_torch.wrappers.KeyedMetric` or
            :class:`~metrics_tpu_torch.wrappers.MultiTenantCollection`
            (anything with ``update(tenant_ids, *cols)`` and ``compute()``).
        max_staleness_s: default read budget (overridable per read).
        read_timeout_s: bound on a blocking cache-miss read.
        on_degraded: the refresh's policy for a round that raises or times
            out (``"retry"`` / ``"stale"`` / ``"quorum"``).
        round_timeout_s: per-round timeout of a refresh.
        queue kwargs (``max_batch``, ``max_delay_ms``, ``capacity_rows``,
            ``policy``, ``block_timeout_s``, ``tenant_quota_rows``,
            ``pad_to_bucket``, ``staging``, ``device``, ``start``, ...)
            configure the owned
            :class:`~metrics_tpu_torch.serving.queue.AdmissionQueue`; its
            device defaults to the metric's.
    """

    def __init__(
        self,
        metric: Any,
        *,
        max_staleness_s: float = DEFAULT_MAX_STALENESS_S,
        read_timeout_s: float = DEFAULT_READ_TIMEOUT_S,
        on_degraded: str = "retry",
        round_timeout_s: Optional[float] = None,
        **queue_kwargs: Any,
    ) -> None:
        for attr in ("update", "compute"):
            if not callable(getattr(metric, attr, None)):
                raise TypeError(f"metric must provide {attr}(); got {type(metric).__name__}")
        if max_staleness_s < 0:
            raise ValueError(f"max_staleness_s must be >= 0, got {max_staleness_s}")
        self._metric = metric
        self.max_staleness_s = float(max_staleness_s)
        self.read_timeout_s = float(read_timeout_s)
        self.on_degraded = on_degraded
        self.round_timeout_s = round_timeout_s
        self._lock = threading.Lock()
        self._generation = 0
        #: tenant id -> generation of its last dispatched write
        self._tenant_gen: Dict[int, int] = {}
        #: the metric's tenant count the ledger was last pruned against
        self._pruned_for_tenants: Optional[int] = getattr(metric, "num_tenants", None)
        #: {"generation", "values", "at", "epoch", "span"}: the result cache
        self._cache: Optional[Dict[str, Any]] = None
        self._refresh_future: Optional[Any] = None
        self._refresh_generation = -1
        self.telemetry_key = TELEMETRY.register(self)
        self.queue = AdmissionQueue(self._dispatch, **queue_kwargs)

    @property
    def device(self) -> Optional[torch.device]:
        """The metric's device, where the queue copies each cohort."""
        return getattr(self._metric, "device", None)

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------

    def _dispatch(self, tenant_ids: Any, *cols: Any) -> None:
        """The queue's flush target: ONE keyed update, then a generation bump
        stamped on the tenants the flush touched (read from the host view)."""
        self._metric.update(tenant_ids, *cols)
        touched = np.unique(np.asarray(tenant_ids).reshape(-1))
        with self._lock:
            self._generation += 1
            for t in touched.tolist():
                self._tenant_gen[t] = self._generation
        SERVING_STATS.inc("generation_bumps")
        self.prune_tenant_generations()

    def prune_tenant_generations(self) -> int:
        """Drop ledger entries of tenants past the metric's current tenant
        count (``scheduler.py:152``); returns the entries dropped. It runs
        after every flush but works only when the count changed since the
        last prune (an elastic shrink), so an entry of a compacted tenant can
        neither leak nor mark a later tenant reusing the id as written."""
        n = getattr(self._metric, "num_tenants", None)
        if n is None:
            return 0
        with self._lock:
            if n == self._pruned_for_tenants:
                return 0
            stale = [t for t in self._tenant_gen if t >= n]
            for t in stale:
                del self._tenant_gen[t]
            self._pruned_for_tenants = n
        if stale and TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "tenant_generations_pruned", len(stale))
        return len(stale)

    def tenant_generations(self) -> Dict[int, int]:
        """One consistent copy of the per-tenant write-generation ledger
        (pruned first): the checkpoint plane's delta dirty-set source."""
        self.prune_tenant_generations()
        with self._lock:
            return dict(self._tenant_gen)

    def submit(self, tenant_id: int, *args: Any) -> bool:
        """Admit one event row (see :meth:`AdmissionQueue.submit`)."""
        return self.queue.submit(tenant_id, *args)

    def submit_many(self, tenant_ids: Any, *cols: Any) -> int:
        """Admit a row cohort (see :meth:`AdmissionQueue.submit_many`)."""
        return self.queue.submit_many(tenant_ids, *cols)

    @property
    def generation(self) -> int:
        """Write generation: dispatched flushes so far."""
        with self._lock:
            return self._generation

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------

    def read(self, tenant_ids: Optional[Any] = None, *, max_staleness_s: Optional[float] = None) -> Any:
        """Per-tenant computed values under the staleness SLO.

        ``tenant_ids=None`` returns the full per-tenant values (or
        ``{member: values}`` for a collection) as they lie; an id array
        selects rows (host arrays, copied from the device) and scopes
        freshness to those tenants. ``max_staleness_s`` overrides the default
        for this read; ``0`` forces read-your-writes freshness. Every read
        records a ``serving`` read span and feeds the
        ``serving_read_staleness_seconds`` histogram."""
        SERVING_STATS.inc("reads")
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "reads")
        span = TRACER.begin("serving", group=self.telemetry_key, bucket="read")
        try:
            values, outcome, evidence = self._read_once(tenant_ids, max_staleness_s)
        except BaseException as err:
            TRACER.end(span, outcome="error", error=f"{type(err).__name__}: {err}")
            raise
        if TELEMETRY.enabled:
            observe_read_staleness(evidence.get("staleness_s", 0.0), outcome)
        TRACER.end(span, outcome=outcome, **evidence)
        return values

    def _read_once(self, tenant_ids: Optional[Any], max_staleness_s: Optional[float]) -> Any:
        """One read: ``(selected values, outcome, evidence)``. ``staleness_s``
        is the served cache's age for stale serves and 0 otherwise."""
        budget = self.max_staleness_s if max_staleness_s is None else float(max_staleness_s)
        now = time.monotonic()
        ids = None if tenant_ids is None else np.asarray(tenant_ids).reshape(-1)
        # a value computed under an older membership epoch's peer set expires
        epoch = _membership_epoch()
        with self._lock:
            cache = self._cache
            if cache is not None and cache.get("epoch", 0) != epoch:
                cache = None
            generation = self._generation
            tenant_scoped_fresh = (
                cache is not None
                and cache["generation"] != generation
                and ids is not None
                and all(self._tenant_gen.get(int(t), 0) <= cache["generation"] for t in ids)
            )

        def _evidence(entry: Optional[Dict[str, Any]], staleness: float) -> Dict[str, Any]:
            return {
                "staleness_s": round(max(0.0, staleness), 9),
                "generation": generation,
                "cache_generation": entry["generation"] if entry else None,
                "flush_span": entry.get("span") if entry else None,
            }

        if cache is not None and self.queue.depth() == 0:
            if cache["generation"] == generation:
                SERVING_STATS.inc("cache_hits")
                return _select(cache["values"], ids), "cache_hit", _evidence(cache, 0.0)
            if tenant_scoped_fresh:
                # other tenants' flushes moved the generation; the requested
                # tenants are unchanged since the cache computed
                SERVING_STATS.inc("cache_hits")
                SERVING_STATS.inc("tenant_cache_hits")
                if TELEMETRY.enabled:
                    TELEMETRY.inc(self.telemetry_key, "tenant_cache_hits")
                return _select(cache["values"], ids), "tenant_cache_hit", _evidence(cache, 0.0)
        if cache is not None and (now - cache["at"]) <= budget:
            # within the SLO: serve the cached generation and refresh behind it
            SERVING_STATS.inc("stale_serves")
            self._ensure_refresh()
            return _select(cache["values"], ids), "stale_serve", _evidence(cache, now - cache["at"])
        SERVING_STATS.inc("cache_misses")
        future, target = self._ensure_refresh()
        values = future.result(timeout=self.read_timeout_s)
        self._install_cache(target, values)
        with self._lock:
            installed = self._cache
        return _select(values, ids), "cache_miss", _evidence(installed, 0.0)

    def refresh(self, wait: bool = False) -> Any:
        """Schedule (or join) a cache refresh; returns its
        :class:`~metrics_tpu_torch.utilities.async_sync.SyncFuture`.
        ``wait=True`` blocks until it resolves and installs the cache."""
        future, target = self._ensure_refresh()
        if wait:
            self._install_cache(target, future.result(timeout=self.read_timeout_s))
        return future

    def _ensure_refresh(self):
        """One in-flight refresh per scheduler, shared by concurrent stale
        reads; it flushes resident rows first, so the snapshot covers
        everything admitted before the read."""
        with self._lock:
            future = self._refresh_future
            if (
                future is not None
                and not future.done()
                and self._refresh_generation >= self._generation
                and self.queue.depth() == 0
            ):
                SERVING_STATS.inc("coalesced_refreshes")
                return future, self._refresh_generation
        # read-your-writes (serialized on the queue's dispatch lock)
        self.queue.flush()
        with self._lock:
            future = self._refresh_future
            if future is not None and not future.done() and self._refresh_generation >= self._generation:
                SERVING_STATS.inc("coalesced_refreshes")
                return future, self._refresh_generation
            target = self._generation
            shadow = _clone(self._metric)

            def thunk(shadow=shadow, target=target):
                # per-attempt clone: a timed-out attempt must not race a retry
                values = _clone(shadow).compute()
                self._install_cache(target, values)
                return values

            key = getattr(self._metric, "telemetry_key", None) or self.telemetry_key
            future = get_engine().submit(
                key, thunk, on_degraded=self.on_degraded, round_timeout_s=self.round_timeout_s
            )
            self._refresh_future = future
            self._refresh_generation = target
        SERVING_STATS.inc("refreshes")
        if TELEMETRY.enabled:
            TELEMETRY.inc(self.telemetry_key, "refreshes")
        if EVENTS.enabled:
            EVENTS.record(
                "serving", self.telemetry_key, path="refresh", generation=target, engine_generation=future.generation
            )
        return future, target

    def _install_cache(self, generation: int, values: Any) -> None:
        # the newest successful dispatch span joins the entry, so read spans
        # can point at the flush that fed their values
        flush_span = self.queue.last_dispatch_span()
        with self._lock:
            if self._cache is None or self._cache["generation"] <= generation:
                self._cache = {"generation": generation, "values": values, "at": time.monotonic(),
                               "epoch": _membership_epoch(),
                               "span": flush_span}

    # ------------------------------------------------------------------
    # introspection / lifecycle
    # ------------------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """Generation and cache state, the queue's exact ledger, and the
        metric's ``tenant_report`` when it has one."""
        with self._lock:
            cache = self._cache
            out: Dict[str, Any] = {
                "generation": self._generation,
                "cache_generation": cache["generation"] if cache else None,
                "cache_age_s": round(time.monotonic() - cache["at"], 6) if cache else None,
                "cache_fresh": bool(cache and cache["generation"] == self._generation),
                "tenant_generations_tracked": len(self._tenant_gen),
                "max_staleness_s": self.max_staleness_s,
                "on_degraded": self.on_degraded,
                "membership_epoch": _membership_epoch(),
                "cache_epoch": cache.get("epoch", 0) if cache else None,
            }
        out["queue"] = self.queue.stats()
        tenant_report = getattr(self._metric, "tenant_report", None)
        if callable(tenant_report):
            out["tenants"] = tenant_report()
        return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Flush and wait out every resident row (see :meth:`AdmissionQueue.drain`)."""
        return self.queue.drain(timeout)

    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Close the queue (flushes the residue first)."""
        self.queue.close(timeout)

    def __repr__(self) -> str:
        return (
            f"SLOScheduler({type(self._metric).__name__}, policy={self.queue.policy.name!r},"
            f" max_staleness_s={self.max_staleness_s})"
        )


def _clone(metric: Any) -> Any:
    """Detached snapshot of ``metric``: its ``clone()`` when it has one,
    ``deepcopy`` otherwise (:class:`MultiTenantCollection`, test doubles)."""
    clone = getattr(metric, "clone", None)
    return clone() if callable(clone) else copy.deepcopy(metric)


def _select(values: Any, ids: Optional[np.ndarray]) -> Any:
    """Per-tenant values (a tensor or ``{member: tensor}``) at ``ids``:
    indexed where they lie, then one copy to the host."""
    if ids is None:
        return values
    if isinstance(values, dict):
        return {k: _select(v, ids) for k, v in values.items()}
    if isinstance(values, torch.Tensor):
        return to_host(values[torch.as_tensor(ids, device=values.device)], numpy=True)
    return np.asarray(values)[ids]
