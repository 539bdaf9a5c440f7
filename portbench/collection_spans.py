"""The program's own host spans inside its eager collection update, per
request.

The port records one request an eager ``MetricCollection.update``
(``metrics_tpu_torch.observability.TRACER.host_records()``): the
``collection.update`` span with the self time of every span inside it,
summed by name, its count of host reads and its attrs ``members`` and
``shared_members``. :func:`split` takes the window's requests and splits
each one's host time five ways, which sum to the request's length:

* ``checks``: the input checks of each shared-update class and of each
  member updated alone, less the host reads inside them;
* ``shared``: each shared-update class's deltas (the canonicalization and
  the B1 or B2 launch), less its checks;
* ``members``: each member updated alone, and each member's update from the
  shared deltas, less their checks and reads;
* ``host_read``: every read of tensor values to the host;
* ``rest``: the request less the four above (the group bookkeeping, the
  member loop).

The window's requests are the last ``N`` ``collection.update`` requests
recorded without a profiler, ``N`` the window's updates as the benchmark
counted them (``update_host_ms``'s). The host ring holds 16,384 requests,
fewer than a long window of this loop makes: the split then reads the last
of the window's updates that the ring still holds. The set-up's warm epoch
comes before them and the profiled epochs after.

A program without host requests, or whose collection update opens none (as
before these spans), and a run with the tracer off give ``None``.
"""
from portbench.host_spans import _tracer

NAME = "collection.update"
#: the part each phase's self time goes to; the request's own name and any
#: other phase go to ``rest``
PARTS = {"checks": "checks", "host_read": "host_read", "shared_update": "shared", "member_update": "members"}


def requests(record):
    """The window's ``collection.update`` requests, oldest first, or ``None``."""
    tracer = _tracer()
    n = len(record.spans.get("update", []))
    if tracer is None or n == 0:
        return None
    window = [r for r in tracer.host_records()
              if getattr(r, "name", None) == NAME and hasattr(r, "phases") and not r.profiled]
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
