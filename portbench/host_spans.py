"""The program's own host spans inside its keyed update, per request.

The port records one request a keyed update
(``metrics_tpu_torch.observability.TRACER.host_records()``): the
``keyed.update`` span with the self time of every span inside it, summed by
name (``checks``, ``row_states``, ``scatter``, ``host_read``, and the
request's own), and its count of host reads. :func:`split` takes the
window's requests and splits each one's host time five ways, which sum to
the request's length:

* ``checks``: the bundles' input checks, less the host reads inside them;
* ``host_read``: every read of tensor values to the host;
* ``rows``: the vmapped per-row child updates;
* ``scatter``: the host side of B3/B4;
* ``rest``: the request less the four above (ids, the lock, the states'
  commit, telemetry).

The window's requests are the last ``N`` ``keyed.update`` requests recorded
without a profiler, ``N`` the window's updates as the benchmark counted
them: the same updates as ``update_host_ms``, while the ring holds them all
(the ring's capacity, 16,384 requests, is more than a window makes). The
set-up's warm epoch comes before them and the profiled passes after.

A program without host requests (no ``host_records``, or records of another
form) and a run with the tracer off give ``None``.
"""

#: the part each phase's self time goes to; the request's own name and any
#: other phase go to ``rest``
PARTS = {"checks": "checks", "host_read": "host_read", "row_states": "rows", "scatter": "scatter"}


def _tracer():
    try:
        from metrics_tpu_torch.observability import TRACER
    except ImportError:
        return None
    return TRACER if hasattr(TRACER, "host_records") else None


def requests(record):
    """The window's ``keyed.update`` requests, oldest first, or ``None``."""
    tracer = _tracer()
    n = len(record.spans.get("update", []))
    if tracer is None or n == 0:
        return None
    window = [r for r in tracer.host_records()
              if getattr(r, "name", None) == "keyed.update" and hasattr(r, "phases") and not r.profiled]
    return window[-n:] or None


def _split_one(request):
    out = {part: 0.0 for part in PARTS.values()}
    for name, seconds in request.phases.items():
        if name in PARTS:
            out[PARTS[name]] += seconds
    out["update"] = request.exit_s - request.enter_s
    out["rest"] = out["update"] - sum(out[part] for part in PARTS.values())
    out["reads"] = request.host_reads
    return out


def split(record):
    """The mean per request of each part (seconds; ``reads`` a count), or
    ``None``."""
    window = requests(record)
    if not window:
        return None
    parts = [_split_one(r) for r in window]
    return {k: sum(p[k] for p in parts) / len(parts) for k in parts[0]}


def read_ms(record, part):
    """The mean of ``part`` per request in milliseconds, or ``None``."""
    means = split(record)
    return None if means is None else 1e3 * means[part]
