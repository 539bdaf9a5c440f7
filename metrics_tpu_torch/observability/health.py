"""Numerical health monitoring of metric states: NaN/Inf and zero weight.

Counterpart of ``metrics_tpu/observability/health.py``. A NaN poisoned into
a metric accumulator propagates silently through every ``"sum"`` merge, and
every ``compute()`` until ``reset()`` returns garbage. This module watches
the values flowing through metric states and catches the corruption at the
step it enters:

* :meth:`Metric.check_health` — an explicit scan of the current states
  (NaN/Inf counts per state, zero total-weight for mean-style metrics),
  always available, whatever the policy. It reads the states to the host.
* the **per-update guard** — opt-in via :func:`set_health_policy`; after
  every state advance the new state's leaves reduce to a small
  ``(leaves, 3)`` boolean tensor of flags. The eager paths read the flags
  directly (under ``"raise"`` they raise from the offending call), as the
  JAX package does.
* the **compiled guard** — inside a compiled program (a CUDA graph of
  :class:`~metrics_tpu_torch.utilities.aot.CompiledDispatch`) no value may
  be read to the host, and PyTorch has no host callback inside a graph, so
  the flags stay in a buffer the capture owns: the program's last step
  packs every guard's flags into one flat tensor. After each replay the
  dispatch copies it asynchronously into pinned host memory and records
  an event; the host notes every copy whose event has completed
  (``event.query()``, never a synchronizing call) at the next dispatch and
  at ``check_health``, ``snapshot()`` and ``compute()``. A NaN is therefore
  reported at most one dispatch late, as the JAX package's asynchronous
  ``jax.debug.callback`` reports it. On the CPU the program runs at the
  call, so its flags are noted when the dispatch returns.
* the **keyed rows** — a keyed update evaluates its child's update on every
  event row (``utilities/stacked.py::row_states``, the JAX package's
  ``vmap``); the guard flags each row's state under the child's key, one
  check per row, as the JAX package's guard does inside its ``vmap``.

Policies (:func:`set_health_policy`):

========== ==============================================================
``"off"``  the default: every guard call site reads one attribute, no flag
           is computed and no compiled program changes
``"record"`` unhealthy updates record a ``health`` event and the
           per-metric ``health_events`` counter, nothing else
``"warn"`` record + one ``UserWarning`` per metric naming the states
``"raise"`` record + :class:`MetricHealthError` on the **eager** paths;
           the compiled paths cannot raise into a running program and warn
           once instead
========== ==============================================================

Zero total-weight: metrics that divide by an accumulated denominator (a
scalar ``"sum"`` state named ``total`` or ``weight``) give NaN at
``compute()`` when it is 0. The guard flags a denominator still at zero
*after an update*, with every other state also still zero: the step that
contributed no weight.
"""
import threading
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.observability.registry import TELEMETRY
from metrics_tpu_torch.utilities.data import _is_batched, _is_traced, to_host
from metrics_tpu_torch.utilities.prints import rank_zero_warn

#: accepted health policies, least to most intrusive
POLICIES = ("off", "record", "warn", "raise")

#: flag columns in the guard's packed boolean tensor, in order
_FLAG_KINDS = ("nan", "inf", "zero_weight")


class MetricHealthError(RuntimeError):
    """Raised (policy ``"raise"``, eager paths only) when a metric state
    update produced NaN/Inf values or a zero total-weight."""


#: one guard's place in a compiled program's packed flags:
#: ``(metric key, state labels, source, flags' shape, one check a row)``
FlagSlot = Tuple[str, Tuple[str, ...], str, Tuple[int, ...], bool]


class _Deferred:
    """One compiled dispatch's packed flags on their way to the host:
    ``host`` is complete once ``event`` is (``None``: already on the host)."""

    __slots__ = ("slots", "host", "event")

    def __init__(self, slots: Sequence[FlagSlot], host: torch.Tensor, event: Optional[Any]) -> None:
        self.slots, self.host, self.event = slots, host, event


class HealthMonitor:
    """Thread-safe per-metric health ledger plus the process-wide policy and
    the compiled guard's queue of flags in flight.

    One process-global instance (:data:`HEALTH`) backs the library; private
    instances are supported for tests. The policy read is lock-free, so with
    the default ``"off"`` every guard call site costs one attribute read.
    """

    def __init__(self, policy: str = "off") -> None:
        self._lock = threading.Lock()
        self._policy = policy
        self._records: Dict[str, Dict[str, int]] = {}
        self._warned: set = set()
        #: compiled dispatches' flags not noted yet, oldest first
        self._pending: deque = deque()
        #: CUDA events of noted entries, reused by later dispatches
        self._free_events: List[Any] = []

    # -- policy (lock-free read: guards gate on this every call) ------------

    @property
    def policy(self) -> str:
        return self._policy

    @property
    def enabled(self) -> bool:
        return self._policy != "off"

    def set_policy(self, policy: str) -> None:
        if policy not in POLICIES:
            raise ValueError(f"health policy must be one of {POLICIES}, got {policy!r}")
        self._policy = policy

    # -- recording ----------------------------------------------------------

    def _record_locked(self, key: str) -> Dict[str, int]:
        """``key``'s ledger entry, made at first use (caller holds the lock)."""
        rec = self._records.get(key)
        if rec is None:
            rec = self._records[key] = {"checks": 0, "unhealthy": 0, "nan": 0, "inf": 0, "zero_weight": 0}
        return rec

    def note(
        self,
        key: str,
        flagged: Dict[str, List[str]],
        *,
        source: str,
        escalate: bool = False,
        force: bool = False,
    ) -> bool:
        """Record one health check of metric ``key``. ``flagged`` maps each
        flag kind to the state names that tripped it (all empty = healthy).
        ``escalate`` marks a caller that will raise on unhealthy (no warning
        then); ``force`` records even under policy ``"off"`` (explicit
        ``check_health()`` calls). Returns whether the check was unhealthy;
        never raises."""
        if not (self.enabled or force):
            return False
        unhealthy = any(flagged.get(kind) for kind in _FLAG_KINDS)
        warn_msg = None
        with self._lock:
            rec = self._record_locked(key)
            rec["checks"] += 1
            if unhealthy:
                rec["unhealthy"] += 1
                for kind in _FLAG_KINDS:
                    if flagged.get(kind):
                        rec[kind] += 1
                if self._policy in ("warn", "raise") and not escalate and key not in self._warned:
                    self._warned.add(key)
                    warn_msg = (
                        f"Metric {key} is numerically unhealthy: "
                        + _describe(flagged)
                        + ". The corrupted state will poison every compute() until reset()."
                        " First detection only; the full ledger is in"
                        " observability.snapshot()['health']."
                    )
        if unhealthy:
            TELEMETRY.inc(key, "health_events")
            EVENTS.record(
                "health",
                key,
                source=source,
                **{kind: list(flagged.get(kind, ())) for kind in _FLAG_KINDS},
            )
        if warn_msg is not None:
            rank_zero_warn(warn_msg, UserWarning)
        return unhealthy

    def note_rows(self, key: str, names: Sequence[str], flags: np.ndarray, *, source: str,
                  escalate: bool = False) -> bool:
        """One check per row of ``flags`` (``(rows, leaves, 3)``), as many
        :meth:`note` calls: the healthy rows are counted at once, each
        unhealthy row is noted on its own, in row order. Returns whether any
        row was unhealthy."""
        if not self.enabled:
            return False
        bad = flags.reshape(flags.shape[0], -1).any(axis=1)
        healthy = int(flags.shape[0] - bad.sum())
        if healthy:
            with self._lock:
                self._record_locked(key)["checks"] += healthy
        for r in np.nonzero(bad)[0]:
            self.note(key, _flags_to_dict(names, flags[r]), source=source, escalate=escalate)
        return bool(bad.any())

    # -- the compiled guard's flags in flight --------------------------------

    def defer(self, slots: Sequence[FlagSlot], flags: torch.Tensor) -> None:
        """Queue one compiled dispatch's packed flags (the guards' flags
        flattened and concatenated in ``slots``' order). On the card: an
        asynchronous copy into pinned host memory on the current stream and
        an event after it (no synchronizing call); on the CPU the flags are
        final."""
        if flags.is_cuda:
            host = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
            host.copy_(flags, non_blocking=True)
            with self._lock:
                event = self._free_events.pop() if self._free_events else torch.cuda.Event()
            event.record()
        else:
            host, event = flags.clone(), None
        with self._lock:
            self._pending.append(_Deferred(slots, host, event))

    def drain(self) -> int:
        """Note every queued entry whose copy has completed, oldest first,
        stopping at the first one still in flight (``event.query()``: never a
        synchronizing call). Returns how many were noted."""
        if not self._pending:
            return 0
        ready: List[_Deferred] = []
        with self._lock:
            while self._pending:
                head = self._pending[0]
                if head.event is not None and not head.event.query():
                    break
                ready.append(self._pending.popleft())
                if head.event is not None:
                    self._free_events.append(head.event)
        for entry in ready:
            flat, offset = entry.host.numpy(), 0
            for key, names, source, shape, rows in entry.slots:
                size = int(np.prod(shape))
                flags = flat[offset:offset + size].reshape(shape)
                offset += size
                if rows:
                    self.note_rows(key, names, flags, source=source)
                else:
                    self.note(key, _flags_to_dict(names, flags), source=source)
        return len(ready)

    def in_flight(self) -> int:
        """Compiled dispatches' packed flag copies not noted yet."""
        return len(self._pending)

    # -- reading ------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """JSON view for ``snapshot()``: the policy plus the per-metric
        check/unhealthy ledger (completed flag copies noted first)."""
        self.drain()
        with self._lock:
            return {
                "policy": self._policy,
                "unhealthy_total": sum(r["unhealthy"] for r in self._records.values()),
                "metrics": {k: dict(r) for k, r in self._records.items()},
            }

    def reset(self) -> None:
        """Clear the ledger, the warn-once memory and the flags in flight
        (the policy survives)."""
        with self._lock:
            self._records.clear()
            self._warned.clear()
            self._pending.clear()


#: the process-global health monitor every guard records into
HEALTH = HealthMonitor()


def set_health_policy(policy: str) -> None:
    """Set the process-wide health policy: ``"off"`` (default), ``"record"``,
    ``"warn"``, or ``"raise"`` (see the module docstring's policy table)."""
    HEALTH.set_policy(policy)


def get_health_policy() -> str:
    return HEALTH.policy


def _describe(flagged: Dict[str, List[str]]) -> str:
    parts = []
    for kind in _FLAG_KINDS:
        names = flagged.get(kind)
        if names:
            parts.append(f"{kind} in state(s) {sorted(names)}")
    return "; ".join(parts) or "healthy"


def _denominator_states(metric: Any) -> Tuple[str, ...]:
    """Mean-style denominators: scalar ``"sum"``-reduced states named
    ``total``/``weight`` (``health.py:190``). The flag fires only when the
    *whole* state is still zero after an update, since a metric may leave
    its denominator at zero while other states carry the evidence
    (``Accuracy`` in probabilities mode)."""
    names = []
    for name, fx in getattr(metric, "_reductions", {}).items():
        if fx != "sum" or name not in ("total", "weight"):
            continue
        default = metric._defaults.get(name)
        if getattr(default, "ndim", None) == 0:
            names.append(name)
    return tuple(names)


def _iter_array_states(state: Dict[str, Any]) -> Iterator[Tuple[str, str, Any]]:
    """Yield ``(label, base_name, tensor)`` per tensor leaf; list
    accumulators contribute one labeled entry per element."""
    for name, value in state.items():
        if isinstance(value, (list, tuple)):
            for i, item in enumerate(value):
                if isinstance(item, torch.Tensor):
                    yield f"{name}[{i}]", name, item
        elif isinstance(value, torch.Tensor):
            yield name, name, value


def _inexact(value: torch.Tensor) -> bool:
    return value.is_floating_point() or value.is_complex()


def _flag_exprs(metric: Any, state: Dict[str, Any]) -> Tuple[List[str], Optional[torch.Tensor]]:
    """Per-leaf ``(nan, inf, zero_weight)`` reductions packed into one
    ``(leaves, 3)`` bool tensor on the states' device (``health.py:223``):
    the only data the guard moves to the host."""
    leaves = list(_iter_array_states(state))
    if not leaves:
        return [], None
    denoms = _denominator_states(metric)
    false = torch.zeros((), dtype=torch.bool, device=leaves[0][2].device)
    all_zero = false
    if denoms:
        all_zero = torch.stack([torch.all(value == 0) for _, _, value in leaves]).all()
    rows = []
    for _, base, value in leaves:
        nan = torch.isnan(value).any() if _inexact(value) else false
        inf = torch.isinf(value).any() if _inexact(value) else false
        rows.append(torch.stack([nan, inf, all_zero if base in denoms else false]))
    return [label for label, _, _ in leaves], torch.stack(rows)


def _row_flag_exprs(metric: Any, rows: Dict[str, Any]) -> Tuple[List[str], Optional[torch.Tensor]]:
    """:func:`_flag_exprs` of every event row's state at once: the keyed
    update's per-row states ``(R, ...)`` give ``(R, leaves, 3)``."""
    leaves = [(name, value.reshape(value.shape[0], -1)) for name, value in rows.items()
              if isinstance(value, torch.Tensor)]
    if not leaves:
        return [], None
    denoms = _denominator_states(metric)
    first = leaves[0][1]
    false = torch.zeros(first.shape[0], dtype=torch.bool, device=first.device)
    all_zero = false
    if denoms:
        all_zero = torch.stack([(flat == 0).all(dim=1) for _, flat in leaves]).all(dim=0)
    cols = []
    for name, flat in leaves:
        nan = torch.isnan(flat).any(dim=1) if _inexact(flat) else false
        inf = torch.isinf(flat).any(dim=1) if _inexact(flat) else false
        cols.append(torch.stack([nan, inf, all_zero if name in denoms else false], dim=1))
    return [name for name, _ in leaves], torch.stack(cols, dim=1)


def _flags_to_dict(names: Sequence[str], flags: Any) -> Dict[str, List[str]]:
    flags = np.asarray(flags)
    return {
        kind: [name for name, row in zip(names, flags) if bool(row[col])]
        for col, kind in enumerate(_FLAG_KINDS)
    }


class _Collector(threading.local):
    #: ``[(key, names, source, flags, rows)]`` of the compiled program
    #: running on this thread, else None
    entries: Optional[List[Tuple[str, Tuple[str, ...], str, torch.Tensor, bool]]] = None


_COLLECT = _Collector()


@contextmanager
def collect_guard_flags() -> Iterator[List[Tuple[str, Tuple[str, ...], str, torch.Tensor, bool]]]:
    """For the block (a compiled program's run or capture on this thread),
    collect the guards' flag tensors into the yielded list instead of
    reading them; the compiled dispatch packs them (:func:`pack_guard_flags`)
    and hands them to :meth:`HealthMonitor.defer`."""
    saved, _COLLECT.entries = _COLLECT.entries, []
    try:
        yield _COLLECT.entries
    finally:
        _COLLECT.entries = saved


def pack_guard_flags(collected: List[Tuple[str, Tuple[str, ...], str, torch.Tensor, bool]]
                     ) -> Tuple[List[FlagSlot], Optional[torch.Tensor]]:
    """The collected guards' slots and their flags as one flat tensor (one
    copy to the host a dispatch); ``([], None)`` when no guard ran."""
    if not collected:
        return [], None
    slots = [(key, names, source, tuple(flags.shape), rows) for key, names, source, flags, rows in collected]
    return slots, torch.cat([flags.reshape(-1) for *_, flags, _ in collected])


def _guard(metric: Any, names: List[str], flags: Optional[torch.Tensor], source: str, rows: bool) -> None:
    key = metric.telemetry_key
    if flags is None:
        HEALTH.note(key, {}, source=source)
        return
    if _is_traced():
        # inside a compiled program: the dispatch moves the flags later
        if _COLLECT.entries is not None:
            _COLLECT.entries.append((key, tuple(names), source, flags, rows))
        return
    escalate = HEALTH.policy == "raise"
    host = to_host(flags, numpy=True)  # the eager guard's direct read
    if rows:
        unhealthy = HEALTH.note_rows(key, names, host, source=source, escalate=escalate)
        if unhealthy and escalate:
            bad = host.reshape(host.shape[0], -1).any(axis=1)
            flagged = _flags_to_dict(names, host[np.nonzero(bad)[0][0]])
            raise MetricHealthError(f"Metric {key}: {_describe(flagged)} (after {source})")
        return
    flagged = _flags_to_dict(names, host)
    unhealthy = HEALTH.note(key, flagged, source=source, escalate=escalate)
    if unhealthy and escalate:
        raise MetricHealthError(f"Metric {key}: {_describe(flagged)} (after {source})")


def guard_state(metric: Any, state: Dict[str, Any], source: str = "update") -> None:
    """The per-update guard (``health.py:288``): scan ``state``'s leaves and
    apply the policy. Call sites gate on ``HEALTH.enabled``. Inside a
    compiled program the flags are collected for the dispatch; a state of
    ``torch.func.vmap`` batched tensors is skipped, since the keyed update
    guards its rows itself (:func:`guard_rows`)."""
    if not HEALTH.enabled:
        return
    if any(_is_batched(v) for _, _, v in _iter_array_states(state)):
        return
    names, flags = _flag_exprs(metric, state)
    _guard(metric, names, flags, source, rows=False)


def guard_rows(metric: Any, rows: Dict[str, Any], source: str = "apply_update") -> None:
    """The guard of a keyed update's per-row states (``(R, ...)`` leaves of
    ``metric``'s states): one check per row under ``metric``'s key."""
    if not HEALTH.enabled:
        return
    if any(_is_batched(v) for v in rows.values()):
        return
    names, flags = _row_flag_exprs(metric, rows)
    _guard(metric, names, flags, source, rows=True)


def check_state(metric: Any, state: Dict[str, Any]) -> Dict[str, Any]:
    """Eager health report of ``state`` (the engine of
    :meth:`Metric.check_health`, ``health.py:336``): per-state NaN/Inf
    element counts and the zero total-weight flag. Works at any policy
    (including ``"off"``); records a ``health`` event and counter when
    something is wrong, never raises or warns. Reads the states to the host."""
    HEALTH.drain()
    key = metric.telemetry_key
    denoms = _denominator_states(metric)
    updated = bool(getattr(metric, "_update_called", True))
    leaves = list(_iter_array_states(state))
    # a fresh (never-updated) metric legitimately holds total == 0; only an
    # updated one whose WHOLE state is still zero accumulated no weight
    all_zero = bool(denoms) and updated and all(bool(to_host(torch.all(value == 0))) for _, _, value in leaves)
    states: Dict[str, Any] = {}
    flagged: Dict[str, List[str]] = {kind: [] for kind in _FLAG_KINDS}
    for label, base, value in leaves:
        entry = {
            "nan": int(to_host(torch.isnan(value).sum())) if _inexact(value) else 0,
            "inf": int(to_host(torch.isinf(value).sum())) if _inexact(value) else 0,
        }
        if base in denoms:
            entry["zero_weight"] = all_zero
        for kind in _FLAG_KINDS:
            if entry.get(kind):
                flagged[kind].append(label)
        states[label] = entry
    healthy = not any(flagged.values())
    if not healthy:
        HEALTH.note(key, flagged, source="check_health", escalate=True, force=True)
    return {"metric": key, "healthy": healthy, "policy": HEALTH.policy, "states": states}
