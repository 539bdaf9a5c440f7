"""Unified resilience policies: retry, deadline and circuit-breaker vocabulary.

Counterpart of ``metrics_tpu/resilience/policies.py`` (a copy; host-only).
One vocabulary covers every plane that retries, waits or trips:

* :class:`RetryPolicy` — bounded exponential backoff with a multiplier cap.
  The async engine's retry loop runs on it
  (``AsyncSyncEngine(retry_policy=...)``; the ``max_retries``/``backoff_s``
  knobs construct one).
* :class:`DeadlineBudget` — one wall-clock budget shared across the
  sequential steps of a compound operation, so N steps can never wait N
  times the budget.
* :class:`CircuitBreaker` — consecutive-failure trip with timed half-open
  probes. The admission queue can front its dispatch with one
  (``AdmissionQueue(breaker=...)``): while open, cohorts shed at once under
  the exact reason ``breaker_open``, and a half-open probe closes it again
  on the first success.

Per-plane defaults live in :data:`PLANE_POLICIES`
(:func:`retry_policy_for` / :func:`set_retry_policy`). Decisions surface in
the ``resilience.*`` counters (``policy_retries``, ``deadline_exhausted``,
``breaker_opens``, ``breaker_short_circuits``).
"""
import threading
import time
from typing import Dict, Optional

from metrics_tpu_torch.resilience.telemetry import RESILIENCE_STATS

__all__ = [
    "CircuitBreaker",
    "DeadlineBudget",
    "DeadlineExhausted",
    "PLANE_POLICIES",
    "RetryPolicy",
    "retry_policy_for",
    "set_retry_policy",
]


class DeadlineExhausted(TimeoutError):
    """A :class:`DeadlineBudget` ran out before the compound operation
    finished."""


class RetryPolicy:
    """Bounded exponential backoff: attempt ``k`` (1-based retry index)
    sleeps ``min(backoff_s * multiplier**(k-1), max_backoff_s)``; after
    ``max_retries`` retries the caller's terminal path runs. Immutable and
    shareable across threads."""

    __slots__ = ("max_retries", "backoff_s", "multiplier", "max_backoff_s")

    def __init__(
        self,
        max_retries: int = 2,
        backoff_s: float = 0.05,
        *,
        multiplier: float = 2.0,
        max_backoff_s: float = 2.0,
    ) -> None:
        if int(max_retries) < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if float(backoff_s) < 0:
            raise ValueError(f"backoff_s must be >= 0, got {backoff_s}")
        if float(multiplier) < 1.0:
            raise ValueError(f"multiplier must be >= 1, got {multiplier}")
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.multiplier = float(multiplier)
        self.max_backoff_s = float(max_backoff_s)

    def backoff(self, attempt: int) -> float:
        """Sleep length before retry ``attempt`` (1-based)."""
        if attempt < 1:
            return 0.0
        return min(
            self.backoff_s * self.multiplier ** (attempt - 1), self.max_backoff_s
        )

    def should_retry(self, attempt: int) -> bool:
        """True while retry ``attempt`` (1-based) is inside the bound."""
        return attempt <= self.max_retries

    def sleep(self, attempt: int) -> float:
        """Count and perform the backoff sleep for retry ``attempt``;
        returns the slept duration."""
        RESILIENCE_STATS.inc("policy_retries")
        dur = self.backoff(attempt)
        if dur > 0:
            time.sleep(dur)
        return dur

    def with_overrides(
        self, max_retries: Optional[int] = None, backoff_s: Optional[float] = None
    ) -> "RetryPolicy":
        """A copy with the legacy per-call knobs applied (how the async
        engine's ``max_retries=``/``backoff_s=`` arguments map onto the
        unified vocabulary)."""
        if max_retries is None and backoff_s is None:
            return self
        return RetryPolicy(
            self.max_retries if max_retries is None else int(max_retries),
            self.backoff_s if backoff_s is None else float(backoff_s),
            multiplier=self.multiplier,
            max_backoff_s=self.max_backoff_s,
        )

    def __repr__(self) -> str:
        return (
            f"RetryPolicy(max_retries={self.max_retries}, backoff_s={self.backoff_s},"
            f" multiplier={self.multiplier}, max_backoff_s={self.max_backoff_s})"
        )

    def __eq__(self, other: object) -> bool:
        return isinstance(other, RetryPolicy) and all(
            getattr(self, f) == getattr(other, f) for f in RetryPolicy.__slots__
        )


class DeadlineBudget:
    """One wall-clock budget shared by the sequential steps of a compound
    operation (a subgroup round's N per-peer reads, an auto-save's
    snapshot+write). The clock starts at construction; each step asks
    :meth:`remaining` (or :meth:`remaining_ms`) for ITS bound, so the total
    can never exceed ``total_s`` no matter how many steps run.

    ``total_s=None`` is the unbounded budget (remaining is ``None``/huge) —
    callers keep one code path."""

    __slots__ = ("total_s", "_t0")

    def __init__(self, total_s: Optional[float]) -> None:
        if total_s is not None and float(total_s) <= 0:
            raise ValueError(f"total_s must be > 0 (or None), got {total_s}")
        self.total_s = None if total_s is None else float(total_s)
        self._t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def remaining(self, *, floor: float = 0.0) -> Optional[float]:
        """Seconds left (``None`` when unbounded); never below ``floor``."""
        if self.total_s is None:
            return None
        return max(floor, self.total_s - self.elapsed())

    def remaining_ms(self, *, floor_ms: float = 1.0) -> Optional[int]:
        rem = self.remaining()
        if rem is None:
            return None
        return int(max(floor_ms, rem * 1e3))

    @property
    def expired(self) -> bool:
        return self.total_s is not None and self.elapsed() >= self.total_s

    def check(self, what: str = "operation") -> None:
        """Raise :class:`DeadlineExhausted` (and count it) when expired."""
        if self.expired:
            RESILIENCE_STATS.inc("deadline_exhausted")
            raise DeadlineExhausted(
                f"{what} exceeded its {self.total_s}s deadline budget"
                f" ({self.elapsed():.3f}s elapsed)"
            )

    def __repr__(self) -> str:
        return f"DeadlineBudget(total_s={self.total_s}, elapsed={self.elapsed():.3f})"


class CircuitBreaker:
    """Consecutive-failure circuit with timed half-open probes.

    ``closed`` (normal) → ``open`` after ``failure_threshold`` consecutive
    :meth:`record_failure` calls (counted ``breaker_opens``); while open,
    :meth:`allow` returns False (counted ``breaker_short_circuits``) until
    ``reset_after_s`` elapses, when exactly one caller is admitted as the
    half-open probe — its success closes the circuit, its failure re-opens
    (and re-arms the timer). Thread-safe."""

    def __init__(self, failure_threshold: int = 5, reset_after_s: float = 30.0) -> None:
        if int(failure_threshold) < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        if float(reset_after_s) <= 0:
            raise ValueError(f"reset_after_s must be > 0, got {reset_after_s}")
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self._lock = threading.Lock()
        self._failures = 0
        self._state = "closed"
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            if (
                self._state == "open"
                and time.monotonic() - self._opened_at >= self.reset_after_s
            ):
                return "half_open"
            return self._state

    def allow(self) -> bool:
        """May the caller attempt the protected operation NOW?"""
        with self._lock:
            if self._state == "closed":
                return True
            if time.monotonic() - self._opened_at >= self.reset_after_s:
                if not self._probing:
                    self._probing = True  # exactly one half-open probe
                    return True
            RESILIENCE_STATS.inc("breaker_short_circuits")
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            self._state = "closed"

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == "open":
                # a failed half-open probe re-arms the timer
                self._opened_at = time.monotonic()
                return
            if self._failures >= self.failure_threshold:
                self._state = "open"
                self._opened_at = time.monotonic()
                RESILIENCE_STATS.inc("breaker_opens")

    def reset(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = "closed"
            self._probing = False

    def __repr__(self) -> str:
        return (
            f"CircuitBreaker(state={self.state!r}, failures={self._failures},"
            f" threshold={self.failure_threshold})"
        )


#: per-plane retry defaults — override with :func:`set_retry_policy`
PLANE_POLICIES: Dict[str, RetryPolicy] = {
    "async_sync": RetryPolicy(max_retries=2, backoff_s=0.05),
    "subgroup": RetryPolicy(max_retries=1, backoff_s=0.02),
    "checkpoint": RetryPolicy(max_retries=2, backoff_s=0.2),
}
_PLANE_LOCK = threading.Lock()


def retry_policy_for(plane: str) -> RetryPolicy:
    """The plane's current retry policy (falls back to the ``async_sync``
    default for unknown planes — one vocabulary, forgiving lookup)."""
    with _PLANE_LOCK:
        return PLANE_POLICIES.get(plane) or PLANE_POLICIES["async_sync"]


def set_retry_policy(plane: str, policy: RetryPolicy) -> RetryPolicy:
    """Install a per-plane override; returns the previous policy."""
    if not isinstance(policy, RetryPolicy):
        raise TypeError(f"policy must be a RetryPolicy, got {type(policy).__name__}")
    with _PLANE_LOCK:
        previous = PLANE_POLICIES.get(plane)
        PLANE_POLICIES[plane] = policy
        return previous if previous is not None else PLANE_POLICIES["async_sync"]
