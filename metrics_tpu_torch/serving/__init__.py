"""Online serving: metrics as a service on top of the keyed state.

Counterpart of ``metrics_tpu/serving/__init__.py``. Many threads submit
per-tenant event rows continuously, and dashboards read per-tenant values
against a latency and staleness SLO. The plane is host-side Python around
the keyed wrappers, whose updates run the segment-scatter kernels (B3, B4)
on the card:

* :class:`~metrics_tpu_torch.serving.queue.AdmissionQueue` — many-threaded
  ingest coalesced into ONE keyed update per flush, flushed at ``max_batch``
  rows or ``max_delay_ms``, whichever comes first.
* :mod:`~metrics_tpu_torch.serving.policy` — backpressure and load shedding
  at capacity (``block`` / ``shed_oldest`` / ``shed_tenant_over_quota``),
  every shed row exactly accounted.
* :class:`~metrics_tpu_torch.serving.scheduler.SLOScheduler` — a per-tenant
  result cache invalidated by write generations, stale serving within
  ``max_staleness_s``, refreshes coalesced onto the background engine.
* :mod:`~metrics_tpu_torch.serving.staging` — device-resident ingest
  (``AdmissionQueue(staging=True)``): a columnar ring written at submit
  time, pinned slots, and the copy to the card on the queue's side stream,
  double-buffered against the dispatch.
* :mod:`~metrics_tpu_torch.serving.telemetry` — the ``serving.*`` counters
  and histograms in ``observability.snapshot()["serving"]`` and the
  ``metrics_tpu_serving_*`` Prometheus series.

Quickstart::

    from metrics_tpu_torch import Accuracy, KeyedMetric
    from metrics_tpu_torch.serving import SLOScheduler

    svc = SLOScheduler(
        KeyedMetric(Accuracy(), num_tenants=10_000, validate_ids=False),
        max_batch=2048, max_delay_ms=5.0, policy="shed_oldest",
        max_staleness_s=1.0, pad_to_bucket=True,
    )
    svc.submit(tenant_id, score, label)      # any thread, host values
    values = svc.read([tenant_id])           # numpy, SLO-governed
    svc.close()

The metric lives on ``"cuda"`` by default, and the queue copies each cohort
to the metric's device (``device=`` names another). Build both with
``device="cpu"`` to run without a card. At drain, rows submitted − rows shed
== ``tenant_report()["rows_routed"]``, with every shed row counted in
``stats()`` and the ``serving.*`` counters.
"""
from metrics_tpu_torch.serving.policy import POLICIES, AdmissionPolicy, resolve_policy  # noqa: F401
from metrics_tpu_torch.serving.queue import AdmissionQueue, QueueClosedError  # noqa: F401
from metrics_tpu_torch.serving.scheduler import SLOScheduler  # noqa: F401
from metrics_tpu_torch.serving.staging import (  # noqa: F401
    StagedCohort,
    StagedColumn,
    StagingRing,
    StagingSlotPool,
)
from metrics_tpu_torch.serving.telemetry import SERVING_STATS, ServingStats, summary  # noqa: F401

__all__ = [
    "POLICIES",
    "AdmissionPolicy",
    "AdmissionQueue",
    "QueueClosedError",
    "SERVING_STATS",
    "SLOScheduler",
    "ServingStats",
    "StagedCohort",
    "StagedColumn",
    "StagingRing",
    "StagingSlotPool",
    "resolve_policy",
    "summary",
]
