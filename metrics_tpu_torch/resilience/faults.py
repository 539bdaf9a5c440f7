"""Unified, seeded fault injection at named seams.

Counterpart of ``metrics_tpu/resilience/faults.py`` (``SEAMS`` ``:64-82``,
``FaultSpec`` ``:115``, ``FaultPlan`` ``:195``, ``maybe_fault`` ``:361``):
the same seams, modes, seeded streams, hit counting and report, consulted
at the same places of the port (``utilities/distributed.py``'s two gather
rounds, ``transport/gather.py``'s subgroup channel, the async engine's
attempts, the admission queue's dispatch and the seven checkpoint steps).
A seam consults a module global and never touches a tensor, so an
uninstalled plan adds no synchronizing call on the card.

Every plane in the library grew its own fault hooks as it grew its own
defenses: the durability plane's ``inject_crash`` crash points, the async
engine's flaky-peer test shims, ad-hoc monkeypatched transport failures in
the test suite. This module replaces them with ONE vocabulary the tests and
the chaos soak share:

* a **seam** is a named host-side injection point the library consults on
  its fault-relevant paths (:data:`SEAMS` — transport rounds, the subgroup
  channel exchange, async-engine attempts, admission-queue dispatch, every
  checkpoint protocol step);
* a :class:`FaultSpec` arms one seam with a **mode** — ``delay`` (sleep
  before the operation), ``drop`` (the operation is abandoned:
  :class:`DroppedFault`), ``error`` (a transient failure:
  :class:`FaultInjected`), ``corrupt`` (the call site is handed a
  deterministic byte-corruptor to apply to its payload), ``crash`` (a
  process-death stand-in: :class:`CrashFault`; the checkpoint seams
  translate it to the durability plane's ``CheckpointCrash``) — firing at
  explicit hit indices (``at``), with a seeded probability (``prob``), or
  on every hit, optionally capped (``times``) and restricted to one
  simulated process (``process``);
* a :class:`FaultPlan` bundles specs under one seed. **Determinism is the
  point**: a plan built from ``(seed, specs)`` fires the same faults at the
  same seam hit counts on every run, so a chaos soak failure reproduces
  from its seed alone.

Install a plan process-wide with :func:`install_fault_plan` (or the
scoped :func:`fault_plan` context manager); the library's seams call
:func:`maybe_fault`, which is a single attribute read when no plan is
installed — fault injection disabled adds zero traced ops AND near-zero
host work (the zero-overhead gate's resilience-off sweep pins the former in the JAX
package).

Every fired fault is counted (``resilience.faults_injected``, split by
seam and mode) and lands on the event timeline, so a chaos run's schedule
is reconstructible from its telemetry.
"""
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from metrics_tpu_torch.resilience.telemetry import note_fault

__all__ = [
    "CrashFault",
    "DroppedFault",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "MODES",
    "SEAMS",
    "current_fault_plan",
    "fault_plan",
    "install_fault_plan",
    "maybe_fault",
]

#: the named seams the library consults (grouped by plane). The checkpoint
#: seams mirror ``durability.checkpoint.CRASH_POINTS`` one-to-one, so the
#: legacy ``inject_crash`` hook and a FaultPlan arm the same places.
SEAMS = (
    # eager gather transport (utilities/distributed.py::_gather_all_leaves)
    "transport.descriptor",
    "transport.payload",
    # the registered subgroup channel (transport/gather.py)
    "subgroup.exchange",
    # background sync engine attempts (utilities/async_sync.py)
    "async.attempt",
    # admission-queue coalesced dispatch (serving/queue.py)
    "serving.dispatch",
    # checkpoint protocol steps (durability/checkpoint.py::CRASH_POINTS)
    "checkpoint.before_shard",
    "checkpoint.after_shard",
    "checkpoint.before_manifest",
    "checkpoint.after_manifest",
    "checkpoint.before_rename",
    "checkpoint.after_rename",
    "checkpoint.before_latest",
)

#: the fault modes a spec can arm
MODES = ("delay", "drop", "error", "corrupt", "crash")


class FaultInjected(RuntimeError):
    """A seam fired in ``error`` mode — a transient failure the surrounding
    policy (retry / stale / quorum / shed accounting) must absorb."""

    def __init__(self, seam: str, mode: str = "error") -> None:
        super().__init__(f"injected {mode} fault at seam {seam!r}")
        self.seam = seam
        self.mode = mode


class DroppedFault(FaultInjected):
    """A seam fired in ``drop`` mode — the operation (a transport round, an
    engine attempt) is abandoned as if the payload never arrived."""

    def __init__(self, seam: str) -> None:
        super().__init__(seam, mode="drop")


class CrashFault(FaultInjected):
    """A seam fired in ``crash`` mode — the process-death stand-in (the
    checkpoint seams translate it to ``CheckpointCrash`` so the crash-safe
    protocol tests see their native exception type)."""

    def __init__(self, seam: str) -> None:
        super().__init__(seam, mode="crash")


class FaultSpec:
    """One armed seam. Fires when ALL its filters match a hit:

    Args:
        seam: one of :data:`SEAMS`.
        mode: one of :data:`MODES`.
        at: explicit 0-based hit indices at which to fire (the
            deterministic schedule a chaos soak uses). ``None`` = every hit
            (subject to ``prob``/``times``).
        prob: seeded firing probability per hit (only when ``at`` is
            ``None``; drawn from the plan's per-spec RNG stream, so the
            firing pattern is a pure function of the plan seed).
        times: cap on total fires (``None`` = unlimited).
        delay_s: sleep length for ``delay`` mode.
        process: restrict to one (simulated) process index — the hit's
            ``process=`` context value must match.
        exc: exception class raised for ``error``/``drop``/``crash`` modes
            (defaults by mode; the class is called with the seam name).
    """

    __slots__ = ("seam", "mode", "at", "prob", "times", "delay_s", "process", "exc")

    def __init__(
        self,
        seam: str,
        mode: str,
        *,
        at: Optional[Sequence[int]] = None,
        prob: Optional[float] = None,
        times: Optional[int] = None,
        delay_s: float = 0.05,
        process: Optional[int] = None,
        exc: Optional[Type[BaseException]] = None,
    ) -> None:
        if seam not in SEAMS:
            raise ValueError(f"unknown seam {seam!r}; one of {SEAMS}")
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r}; one of {MODES}")
        if at is not None and prob is not None:
            raise ValueError("pass at= (a deterministic schedule) OR prob=, not both")
        if prob is not None and not 0.0 <= float(prob) <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {prob}")
        self.seam = seam
        self.mode = mode
        self.at = frozenset(int(i) for i in at) if at is not None else None
        self.prob = float(prob) if prob is not None else None
        self.times = int(times) if times is not None else None
        self.delay_s = float(delay_s)
        self.process = int(process) if process is not None else None
        self.exc = exc

    def __repr__(self) -> str:
        sched = (
            f"at={sorted(self.at)}" if self.at is not None
            else f"prob={self.prob}" if self.prob is not None
            else "always"
        )
        return f"FaultSpec({self.seam}, {self.mode}, {sched})"


class _Corruptor:
    """Deterministic byte corruptor handed to ``corrupt``-mode call sites:
    flips one seeded byte per kilobyte of the payload (enough to break any
    checksum, deterministic from the plan seed + fire index)."""

    def __init__(self, seed: int) -> None:
        self.mode = "corrupt"
        self._seed = int(seed)

    def corrupt(self, data: Any) -> np.ndarray:
        arr = np.asarray(data)
        flat = arr.reshape(-1).view(np.uint8).copy()
        if flat.size == 0:
            return arr
        rng = np.random.RandomState(self._seed)
        idx = rng.randint(0, flat.size, size=max(1, flat.size // 1024))
        flat[idx] ^= 0xFF
        return flat.view(arr.dtype.newbyteorder("="))[: arr.size].reshape(arr.shape)


class FaultPlan:
    """A seeded, deterministic fault schedule over the named seams.

    Per-seam hit counters advance on every :func:`maybe_fault` consult
    (whether or not a spec fires), so ``at=[k]`` names the k-th time the
    library reaches that seam — a stable coordinate across runs. Seams that
    pass a ``process=`` context (the transport rounds, the subgroup
    channel) count per ``(seam, process)``: with several simulated ranks
    hitting one seam concurrently, ``at=[0]`` + ``process=1`` names rank
    1's OWN first hit, not a thread-interleaving-dependent global index.
    Thread safety: counters advance under one lock; with ``prob`` specs the
    draw order across threads follows the (locked) hit order.
    """

    def __init__(self, seed: int = 0, specs: Sequence[FaultSpec] = ()) -> None:
        self.seed = int(seed)
        self.specs: List[FaultSpec] = list(specs)
        for s in self.specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"specs must be FaultSpec, got {type(s).__name__}")
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._fires: Dict[int, int] = {}  # spec index -> fires
        self._fired_log: List[Tuple[str, str, int]] = []  # (seam, mode, hit)
        # one independent seeded stream per prob-spec: the firing pattern is
        # a pure function of (plan seed, spec index, hit order)
        self._rngs: Dict[int, np.random.RandomState] = {
            i: np.random.RandomState((self.seed * 1_000_003 + i) % (2**32))
            for i, s in enumerate(self.specs)
            if s.prob is not None
        }

    def add(self, spec: FaultSpec) -> "FaultPlan":
        """Append one spec (chainable); ``prob`` specs get their seeded
        stream keyed by their index, as at construction."""
        with self._lock:
            self.specs.append(spec)
            i = len(self.specs) - 1
            if spec.prob is not None:
                self._rngs[i] = np.random.RandomState(
                    (self.seed * 1_000_003 + i) % (2**32)
                )
        return self

    # -- firing --------------------------------------------------------------

    def fire(self, seam: str, ctx: Dict[str, Any]) -> Optional[Any]:
        """Consult the plan at ``seam``: advance the hit counter, find the
        first matching armed spec, and APPLY its mode — sleep for ``delay``,
        raise for ``drop``/``error``/``crash``, return a corruptor for
        ``corrupt`` (``None`` when nothing fired)."""
        counter_key = (
            f"{seam}@{ctx['process']}" if "process" in ctx else seam
        )
        with self._lock:
            hit = self._hits.get(counter_key, 0)
            self._hits[counter_key] = hit + 1
            chosen: Optional[Tuple[int, FaultSpec]] = None
            for i, spec in enumerate(self.specs):
                if spec.seam != seam:
                    continue
                if spec.process is not None and ctx.get("process") != spec.process:
                    continue
                if spec.times is not None and self._fires.get(i, 0) >= spec.times:
                    continue
                if spec.at is not None:
                    if hit not in spec.at:
                        continue
                elif spec.prob is not None:
                    if self._rngs[i].random_sample() >= spec.prob:
                        continue
                chosen = (i, spec)
                break
            if chosen is None:
                return None
            i, spec = chosen
            self._fires[i] = self._fires.get(i, 0) + 1
            self._fired_log.append((seam, spec.mode, hit))
            fire_index = len(self._fired_log)
        note_fault(seam, spec.mode, hit=hit, **_jsonable(ctx))
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            return None
        if spec.mode == "corrupt":
            return _Corruptor(self.seed * 97 + fire_index)
        exc = spec.exc
        if exc is not None:
            raise exc(seam)
        if spec.mode == "drop":
            raise DroppedFault(seam)
        if spec.mode == "crash":
            raise CrashFault(seam)
        raise FaultInjected(seam)

    # -- reading -------------------------------------------------------------

    def hits(self, seam: Optional[str] = None) -> Any:
        """Hit counters: one seam's count, or the whole dict."""
        with self._lock:
            if seam is not None:
                return self._hits.get(seam, 0)
            return dict(self._hits)

    def fired(self) -> List[Tuple[str, str, int]]:
        """Chronological ``(seam, mode, hit_index)`` log of every fired
        fault — the chaos soak's schedule evidence."""
        with self._lock:
            return list(self._fired_log)

    def report(self) -> Dict[str, Any]:
        with self._lock:
            by_seam: Dict[str, int] = {}
            for seam, mode, _ in self._fired_log:
                key = f"{seam}:{mode}"
                by_seam[key] = by_seam.get(key, 0) + 1
            return {
                "seed": self.seed,
                "specs": len(self.specs),
                "fired": len(self._fired_log),
                "fired_by_seam": by_seam,
                "hits": dict(self._hits),
            }

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, specs={len(self.specs)}, fired={len(self._fired_log)})"


def _jsonable(ctx: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in ctx.items() if isinstance(v, (str, int, float, bool))}


#: the installed plan — ``None`` (the default) keeps every seam a single
#: attribute read; the soak and the fault tests install one scoped plan
_PLAN: Optional[FaultPlan] = None
_PLAN_LOCK = threading.Lock()


def install_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` process-wide (or clear with ``None``); returns the
    previously installed plan. Prefer the scoped :func:`fault_plan` context
    manager in tests."""
    global _PLAN
    if plan is not None and not isinstance(plan, FaultPlan):
        raise TypeError(f"plan must be a FaultPlan or None, got {type(plan).__name__}")
    with _PLAN_LOCK:
        previous = _PLAN
        _PLAN = plan
    return previous


def current_fault_plan() -> Optional[FaultPlan]:
    """The installed plan, or ``None``."""
    return _PLAN


@contextmanager
def fault_plan(plan: FaultPlan):
    """Install ``plan`` for the duration of the block (exception-safe; the
    previous plan — usually none — is restored on exit)."""
    previous = install_fault_plan(plan)
    try:
        yield plan
    finally:
        install_fault_plan(previous)


def maybe_fault(seam: str, **ctx: Any) -> Optional[Any]:
    """The seam call: a single attribute read when no plan is installed
    (the overwhelmingly common case); otherwise consult the plan — which
    may sleep, raise, or return a corruptor (see :meth:`FaultPlan.fire`)."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.fire(seam, ctx)
