"""Profiling hooks: named spans per metric phase, and step-cost slopes.

Counterpart of ``metrics_tpu/utilities/profiling.py``. Every metric phase
is named in a profiler trace: :func:`compiled_scope` and :func:`eager_span`
open a ``torch.profiler.record_function("metrics/<Metric>.<phase>")``
range, so a ``torch.profiler`` trace shows which metric each launch
belongs to (in place of the JAX package's ``jax.named_scope`` and
``jax.profiler.TraceAnnotation``)::

    with torch.profiler.profile(activities=[...CPU, ...CUDA]) as prof:
        coll(preds, target)              # ranges named per member
    prof.export_chrome_trace("metrics-trace.json")

With no profiler active the hooks return a shared no-op context (one
boolean read), so they cost nothing on the hot path and add nothing to a
CUDA graph capture; under an active profiler a capture records the range
on the host only.

:func:`measure_scan_slope` and :func:`measure_step_overhead` measure the
marginal per-step time of an update, cancelling the fixed launch and copy
latency with a two-length slope: the first runs the port's counterpart of
``lax.scan``, K updates unrolled into one compiled program (on the card one
CUDA graph, as ``update_many`` runs them), the second runs a metric's
``jit_forward`` step back to back.
"""
import contextlib
import time
import warnings
from statistics import median
from typing import Any, Callable, Dict, Optional

import torch

_SCOPE_PREFIX = "metrics"
_NO_SPAN = contextlib.nullcontext()


def compiled_scope(name: str) -> Any:
    """A ``metrics/<name>`` profiler range (a shared no-op without an active
    profiler), for a phase that may run inside a compiled program."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(f"{_SCOPE_PREFIX}/{name}")


#: the eager phases' range: a ``record_function`` range is the same host-side
#: annotation whether or not the phase is captured
eager_span = compiled_scope


def _synchronize(tree: Any) -> None:
    from torch.utils._pytree import tree_leaves

    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def measure_scan_slope(
    all_inputs: Any, init_state: Callable[[], Any], update: Callable, rounds: int = 7,
    stats: Optional[Dict[str, Any]] = None,
) -> float:
    """Marginal per-step time (seconds) of ``update`` unrolled over
    ``all_inputs`` (a tuple of tensors whose leading axis is the step) in one
    compiled program (``profiling.py:52``): the same program runs at 1x and
    5x the step count, and ``(t_long - t_short) / (4 * steps)`` cancels the
    fixed dispatch cost. Each run ends in a host wait for the card. The
    estimate is the larger of the paired-difference median and the
    difference of medians; NaN (with a warning) when the noise swallows the
    signal, never a silent zero. ``stats`` receives the first-call wall
    times of both lengths (capture + one run)."""
    from metrics_tpu_torch.metric import _unrolled
    from metrics_tpu_torch.utilities.aot import CompiledDispatch

    inputs = tuple(all_inputs)
    steps = int(inputs[0].shape[0])
    tiled = tuple(torch.cat([x] * 5, dim=0) for x in inputs)
    program = CompiledDispatch(lambda state, xs: (_unrolled(update, state, xs, {}), None), donate_state=True)

    def run(xs: Any) -> float:
        state = init_state()
        _synchronize(state)
        start = time.perf_counter()
        new_state, _ = program(state, xs)
        _synchronize(new_state)
        return time.perf_counter() - start

    warmup_short, warmup_long = run(inputs), run(tiled)  # capture both lengths
    if stats is not None:
        stats["warmup_short_s"] = round(warmup_short, 3)
        stats["warmup_long_s"] = round(warmup_long, 3)
    return _two_length_slope(lambda: run(inputs), lambda: run(tiled), steps, rounds)


def measure_step_overhead(metric: Any, *example_batch: Any, steps: int = 64, rounds: int = 5) -> float:
    """Marginal per-step time (seconds) of ``metric``'s compiled step
    (``profiling.py:133``): a clone of ``metric`` (a metric or a collection)
    with :meth:`jit_forward` runs ``steps`` and ``5 * steps`` forwards of
    ``example_batch`` back to back, each run ending in a host wait, and the
    two-length slope cancels the fixed cost. Returns NaN when the noise
    swallows the signal; raise ``steps`` until the slope dominates."""
    fwd = metric.clone().jit_forward()
    fwd.warmup(*example_batch)

    def run(n: int) -> float:
        _synchronize(example_batch)
        start = time.perf_counter()
        for _ in range(n):
            out = fwd(*example_batch)
        _synchronize(out)
        return time.perf_counter() - start

    return _two_length_slope(lambda: run(steps), lambda: run(5 * steps), steps, rounds)


def _two_length_slope(short: Callable[[], float], long: Callable[[], float], steps: int, rounds: int) -> float:
    """``(t_long - t_short) / (4 * steps)`` from ``rounds`` back-to-back
    pairs (twice as many on a second attempt): the larger of the
    paired-difference median (which cancels slow drift) and the difference
    of medians (which filters one-sided spikes), keyed on the paired
    estimator being positive; NaN with a warning otherwise."""
    for attempt in range(2):
        shorts, longs = [], []
        for _ in range(rounds * (attempt + 1)):
            longs.append(long())
            shorts.append(short())
        paired = median(lo - sh for lo, sh in zip(longs, shorts))
        if paired > 0:
            return max(paired, median(longs) - median(shorts)) / (4 * steps)
    warnings.warn(
        "slope measurement failed (non-positive median): the per-step signal is"
        " below the timing noise; raise the step count"
    )
    return float("nan")
