"""``merged_leaves_per_update``: the mean count per keyed update of the state
leaves that took the merge, the one launch that routes every int32/float32
leaf of every bundle into its new stacked state
(``kernels/segment_scatter.py::segment_merge_cuda``; the request's
``merged_leaves``), from the program's host requests over the window
(``portbench/host_spans.py``). A program whose requests carry no such count
gives ``None``."""
from portbench import host_spans


def read(record):
    window = host_spans.requests(record)
    if not window or not all(hasattr(r, "merged_leaves") for r in window):
        return None
    return sum(r.merged_leaves for r in window) / len(window)
