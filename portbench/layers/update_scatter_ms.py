"""``update_scatter_ms``: the mean host time per keyed update of the host side
of B3/B4 (``scatter`` spans: column packing, the kernels' wrappers, the state
merge, the invalid-id sum), less any host read inside them, from the
program's host spans over the window's requests
(``portbench/host_spans.py``)."""
from portbench import host_spans


def read(record):
    return host_spans.read_ms(record, "scatter")
