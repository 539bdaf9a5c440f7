"""``update_rows_ms``: the mean host time per keyed update of the vmapped
per-row child updates (``row_states`` spans, ``utilities/stacked.py``), less
any host read inside them, from the program's host spans over the window's
requests (``portbench/host_spans.py``)."""
from portbench import host_spans


def read(record):
    return host_spans.read_ms(record, "rows")
