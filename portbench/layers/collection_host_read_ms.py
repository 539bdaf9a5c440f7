"""``collection_host_read_ms``: the mean host time per eager collection
update spent reading tensor values to the host, the wait for the card
included (``host_read`` spans, ``utilities/data.py::to_host``), from the
program's host spans over the window's requests
(``portbench/collection_spans.py``)."""
from portbench import collection_spans


def read(record):
    return collection_spans.read_ms(record, "host_read")
