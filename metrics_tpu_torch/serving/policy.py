"""Backpressure and load-shedding policies of the admission queue.

Counterpart of ``metrics_tpu/serving/policy.py`` (a copy). What happens when
the queue is at capacity is a policy decision, and every outcome is exactly
accounted: a shed row that is not counted is indistinguishable from a lost
update. Three policies, selected by name (``AdmissionQueue(policy=...)``):

* ``"block"`` — the producer waits (bounded by ``block_timeout_s``) until
  the flusher drains room; rows still unplaceable at the timeout are shed
  under ``reason="block_timeout"``.
* ``"shed_oldest"`` — the oldest queued rows are dropped to admit the new
  ones (``reason="shed_oldest"``): the freshest data wins.
* ``"shed_tenant_over_quota"`` — a row whose tenant already holds
  ``tenant_quota_rows`` queued rows is rejected
  (``reason="tenant_over_quota"``); when the queue is full of under-quota
  rows the incoming row is shed (``reason="queue_full"``).

Every decision is host-side Python, recorded in the ``serving.*`` counters
(:mod:`metrics_tpu_torch.serving.telemetry`).
"""
from typing import Optional

__all__ = ["POLICIES", "resolve_policy", "AdmissionPolicy"]

#: the selectable admission policies
POLICIES = ("block", "shed_oldest", "shed_tenant_over_quota")

#: shed-accounting reasons each policy can emit (docs + tests pin these)
SHED_REASONS = ("block_timeout", "shed_oldest", "tenant_over_quota", "queue_full")


class AdmissionPolicy:
    """Value object naming one admission policy and its knobs.

    The queue consults :attr:`name` at admission time; the policy itself
    holds only configuration (it is shareable across queues and threads).
    """

    __slots__ = ("name", "block_timeout_s", "tenant_quota_rows")

    def __init__(
        self,
        name: str,
        *,
        block_timeout_s: Optional[float] = None,
        tenant_quota_rows: Optional[int] = None,
    ) -> None:
        if name not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {name!r}")
        if block_timeout_s is not None and block_timeout_s < 0:
            raise ValueError(f"block_timeout_s must be >= 0, got {block_timeout_s}")
        if tenant_quota_rows is not None and int(tenant_quota_rows) < 1:
            raise ValueError(
                f"tenant_quota_rows must be >= 1, got {tenant_quota_rows}"
            )
        self.name = name
        self.block_timeout_s = block_timeout_s
        self.tenant_quota_rows = (
            int(tenant_quota_rows) if tenant_quota_rows is not None else None
        )

    def __repr__(self) -> str:
        extra = ""
        if self.block_timeout_s is not None:
            extra += f", block_timeout_s={self.block_timeout_s}"
        if self.tenant_quota_rows is not None:
            extra += f", tenant_quota_rows={self.tenant_quota_rows}"
        return f"AdmissionPolicy({self.name!r}{extra})"


def resolve_policy(policy, **kwargs) -> AdmissionPolicy:
    """``AdmissionPolicy`` from a name or a ready-made instance (the queue's
    constructor seam). Keyword knobs apply only to the name form."""
    if isinstance(policy, AdmissionPolicy):
        if kwargs:
            raise ValueError(
                "pass policy knobs inside the AdmissionPolicy instance, not"
                f" alongside it: {sorted(kwargs)}"
            )
        return policy
    return AdmissionPolicy(str(policy), **kwargs)
