"""Recompile detection: count captures per metric, warn on churn.

Counterpart of ``metrics_tpu/observability/retrace.py``. Every new input
shape or dtype costs a compiled step a fresh program, silently, at step
latency. The port's compiled program is a CUDA graph
(:class:`~metrics_tpu_torch.utilities.aot.CompiledDispatch`), so the
ledger counts **captures** (on the CPU, the first call of a signature),
fed from two sources, as in the JAX package:

* :meth:`RetraceMonitor.note_compile`: a ``jit_forward``/``update_many``
  or keyed dispatch that captured afresh (``fn.last_compiled``), with the
  signature of the call that forced it (``metric.py:158,171``). Past the
  threshold it warns ONCE per metric, naming the recent signatures;
* :meth:`RetraceMonitor.note_trace`: each capture of a pure ``apply_update``
  (``metric.py:537``), counted and never warned about.

``warmup`` captures on purpose and does not feed the warning.
"""
import os
import threading
from collections import deque
from typing import Any, Dict, Optional

import torch

from metrics_tpu_torch.observability.events import EVENTS
from metrics_tpu_torch.utilities.prints import rank_zero_warn

#: default capture budget per metric before the churn warning fires;
#: override via the env var or :func:`set_retrace_threshold`
DEFAULT_RETRACE_THRESHOLD = int(os.environ.get("METRICS_TPU_RETRACE_THRESHOLD", "3"))

#: how many recent argument signatures each record keeps for the warning
_SIGNATURE_WINDOW = 4


def arg_signature(*args: Any, **kwargs: Any) -> str:
    """Compact shape/dtype signature of a call, in the JAX package's
    spelling, e.g. ``(float32[8,3], int64[8])``."""

    def one(x: Any) -> str:
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is not None and dtype is not None:
            dims = ",".join(str(d) for d in shape)
            name = str(dtype).replace("torch.", "") if isinstance(dtype, torch.dtype) else str(dtype)
            return f"{name}[{dims}]"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k}: {one(v)}" for k, v in x.items()) + "}"
        if isinstance(x, (list, tuple)):
            return "[" + ", ".join(one(v) for v in x) + "]"
        return type(x).__name__

    parts = [one(a) for a in args] + [f"{k}={one(v)}" for k, v in sorted(kwargs.items())]
    return "(" + ", ".join(parts) + ")"


class RetraceMonitor:
    """Per-key capture/trace ledger with a threshold-crossing warning."""

    def __init__(self, threshold: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._threshold = DEFAULT_RETRACE_THRESHOLD if threshold is None else int(threshold)
        self._records: Dict[str, Dict[str, Any]] = {}

    def set_threshold(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"retrace threshold must be >= 1, got {n}")
        self._threshold = int(n)

    def get_threshold(self) -> int:
        return self._threshold

    def _record(self, key: str) -> Dict[str, Any]:
        rec = self._records.get(key)
        if rec is None:
            rec = self._records[key] = {
                "compiles": 0,
                "traces": 0,
                "signatures": deque(maxlen=_SIGNATURE_WINDOW),
                "warned": False,
            }
        return rec

    def note_compile(self, key: str, signature: Optional[str] = None, count: int = 1) -> None:
        """Record ``count`` fresh captures of ``key``'s compiled step; warn
        once when the total crosses the threshold."""
        warn_msg = None
        with self._lock:
            rec = self._record(key)
            rec["compiles"] += count
            if signature:
                rec["signatures"].append(signature)
            if rec["compiles"] > self._threshold and not rec["warned"]:
                rec["warned"] = True
                recent = ", ".join(rec["signatures"]) or "<no signatures captured>"
                warn_msg = (
                    f"Metric {key} has compiled its jitted forward {rec['compiles']} times"
                    f" (threshold {self._threshold}). Each new input shape/dtype pays a fresh"
                    f" CUDA graph capture at step latency. Recent input signatures: {recent}."
                    " Pad batches to a fixed shape (or bucket to a few shapes), keep dtypes"
                    " stable, and construct one metric per distinct configuration; raise the"
                    " threshold with metrics_tpu_torch.observability.set_retrace_threshold(n) if"
                    " this churn is intended."
                )
        if EVENTS.enabled:
            EVENTS.record("retrace", key, source="jit_forward", count=count, signature=signature)
        if warn_msg is not None:
            rank_zero_warn(warn_msg, UserWarning)

    def note_trace(self, key: str, signature: Optional[str] = None) -> None:
        """Record one capture of ``key``'s pure update (never warned about:
        capturing a pure function in several programs is often deliberate)."""
        with self._lock:
            self._record(key)["traces"] += 1
        if EVENTS.enabled:
            EVENTS.record("retrace", key, source="trace", signature=signature)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "threshold": self._threshold,
                "metrics": {
                    key: {
                        "compiles": rec["compiles"],
                        "traces": rec["traces"],
                        "warned": rec["warned"],
                        "signatures": list(rec["signatures"]),
                    }
                    for key, rec in self._records.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._records.clear()


#: the process-global monitor the compiled paths feed
MONITOR = RetraceMonitor()


def set_retrace_threshold(n: int) -> None:
    """Set the per-metric capture budget before the churn warning fires."""
    MONITOR.set_threshold(n)


def get_retrace_threshold() -> int:
    return MONITOR.get_threshold()
