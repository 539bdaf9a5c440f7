"""``rows_batched_per_update``: the mean count per keyed update of the state
bundles whose per-row states took the batched-rows form instead of the vmap
(``utilities/stacked.py::row_states``; the request's ``rows_batched``), from
the program's host requests over the window (``portbench/host_spans.py``).
A program whose requests carry no such count gives ``None``."""
from portbench import host_spans


def read(record):
    window = host_spans.requests(record)
    if not window or not all(hasattr(r, "rows_batched") for r in window):
        return None
    return sum(r.rows_batched for r in window) / len(window)
