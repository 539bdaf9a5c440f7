"""The resilience plane: fault injection, failure detection and policy.

Counterpart of ``metrics_tpu/resilience/__init__.py``, with the same
exports:

* :mod:`~metrics_tpu_torch.resilience.faults` — one seeded, deterministic
  :class:`FaultPlan` (delay / drop / error / corrupt / crash at named
  seams) consulted by the gather rounds, the subgroup channel, the async
  engine's attempts, the admission queue's dispatch and every checkpoint
  protocol step;
* :mod:`~metrics_tpu_torch.resilience.detector` /
  :mod:`~metrics_tpu_torch.resilience.membership` — a phi-accrual
  :class:`FailureDetector` fed by the straggler reports and the gather
  rounds' outcomes, promoting peer health into a versioned membership
  epoch read by the async engine's quorum and the serving scheduler;
* :mod:`~metrics_tpu_torch.resilience.policies` — :class:`RetryPolicy`,
  :class:`DeadlineBudget` and :class:`CircuitBreaker`;
* :mod:`~metrics_tpu_torch.resilience.telemetry` — the ``resilience.*``
  counters behind ``snapshot()["resilience"]``.

Everything is host-side: with no plan installed a seam is one module-global
read, and nothing here reads a tensor.
"""
from metrics_tpu_torch.resilience.detector import (  # noqa: F401
    DETECTOR,
    FailureDetector,
    note_round_outcome,
    note_straggler_report,
)
from metrics_tpu_torch.resilience.faults import (  # noqa: F401
    MODES,
    SEAMS,
    CrashFault,
    DroppedFault,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    current_fault_plan,
    fault_plan,
    install_fault_plan,
    maybe_fault,
)
from metrics_tpu_torch.resilience.membership import (  # noqa: F401
    MEMBERSHIP,
    Membership,
    MembershipView,
    alive_processes,
    current_epoch,
    current_view,
    dead_processes,
)
from metrics_tpu_torch.resilience.policies import (  # noqa: F401
    PLANE_POLICIES,
    CircuitBreaker,
    DeadlineBudget,
    DeadlineExhausted,
    RetryPolicy,
    retry_policy_for,
    set_retry_policy,
)
from metrics_tpu_torch.resilience.telemetry import (  # noqa: F401
    RESILIENCE_STATS,
    ResilienceStats,
    summary,
)

__all__ = [
    "DETECTOR",
    "MEMBERSHIP",
    "MODES",
    "PLANE_POLICIES",
    "RESILIENCE_STATS",
    "SEAMS",
    "CircuitBreaker",
    "CrashFault",
    "DeadlineBudget",
    "DeadlineExhausted",
    "DroppedFault",
    "FailureDetector",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "Membership",
    "MembershipView",
    "ResilienceStats",
    "RetryPolicy",
    "alive_processes",
    "current_epoch",
    "current_fault_plan",
    "current_view",
    "dead_processes",
    "fault_plan",
    "install_fault_plan",
    "maybe_fault",
    "note_round_outcome",
    "note_straggler_report",
    "retry_policy_for",
    "set_retry_policy",
    "summary",
]


def reset() -> None:
    """Reset the whole plane for tests: uninstall any fault plan, clear the
    detector's evidence, return the membership to epoch 0 and zero the
    counters. Like any cross-process state: on every process together or
    on none."""
    install_fault_plan(None)
    DETECTOR.reset()
    MEMBERSHIP.reset()
    RESILIENCE_STATS.reset()
