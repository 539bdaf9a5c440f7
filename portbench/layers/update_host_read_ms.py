"""``update_host_read_ms``: the mean host time per keyed update spent reading
tensor values to the host, the wait for the card included (``host_read``
spans, ``utilities/data.py::to_host``), from the program's host spans over the
window's requests (``portbench/host_spans.py``)."""
from portbench import host_spans


def read(record):
    return host_spans.read_ms(record, "host_read")
