"""The resilience plane's policy vocabulary and its telemetry.

Counterpart of ``metrics_tpu/resilience/__init__.py``, limited to the two
host-only modules the serving plane needs:

* :mod:`~metrics_tpu_torch.resilience.policies` — :class:`RetryPolicy`
  (the async engine's retry loop runs on it), :class:`DeadlineBudget` and
  :class:`CircuitBreaker` (the admission queue's ``breaker=``), with the
  per-plane defaults of :func:`retry_policy_for` / :func:`set_retry_policy`;
* :mod:`~metrics_tpu_torch.resilience.telemetry` — the ``resilience.*``
  counters (:data:`RESILIENCE_STATS`) behind ``snapshot()["resilience"]``.

Fault injection (``faults``), the failure detector (``detector``) and the
membership epoch (``membership``) are not ported yet (ROADMAP queue A item
14): until they are, nothing injects a fault, no peer is ever flagged, and
the membership epoch reads 0.
"""
from metrics_tpu_torch.resilience.policies import (  # noqa: F401
    PLANE_POLICIES,
    CircuitBreaker,
    DeadlineBudget,
    DeadlineExhausted,
    RetryPolicy,
    retry_policy_for,
    set_retry_policy,
)
from metrics_tpu_torch.resilience.telemetry import RESILIENCE_STATS, ResilienceStats  # noqa: F401

__all__ = [
    "CircuitBreaker",
    "DeadlineBudget",
    "DeadlineExhausted",
    "PLANE_POLICIES",
    "RESILIENCE_STATS",
    "ResilienceStats",
    "RetryPolicy",
    "retry_policy_for",
    "set_retry_policy",
]
