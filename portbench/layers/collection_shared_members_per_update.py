"""``collection_shared_members_per_update``: the mean count per eager
collection update of the members fed a shared-update class's deltas
instead of updating alone (the request's ``shared_members`` attr,
``collections.py::MetricCollection.update``), from the program's host
requests over the window (``portbench/collection_spans.py``). Requests that
carry no such attr give ``None``."""
from portbench import collection_spans


def read(record):
    window = collection_spans.requests(record)
    if not window or not all("shared_members" in getattr(r, "attrs", {}) for r in window):
        return None
    return sum(r.attrs["shared_members"] for r in window) / len(window)
