"""``update_checks_ms``: the mean host time per keyed update of the input
checks of its state bundles (``checks`` spans, ``utilities/checks.py``), less
the host reads inside them, from the program's host spans over the window's
requests (``portbench/host_spans.py``)."""
from portbench import host_spans


def read(record):
    return host_spans.read_ms(record, "checks")
