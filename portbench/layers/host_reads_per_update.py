"""``host_reads_per_update``: the mean count of reads of tensor values to the
host per keyed update (``host_read`` spans, ``utilities/data.py::to_host``),
from the program's host spans over the window's requests
(``portbench/host_spans.py``)."""
from portbench import host_spans


def read(record):
    means = host_spans.split(record)
    return None if means is None else means["reads"]
