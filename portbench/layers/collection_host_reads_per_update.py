"""``collection_host_reads_per_update``: the mean count of reads of tensor
values to the host per eager collection update (``host_read`` spans,
``utilities/data.py::to_host``), from the program's host spans over the
window's requests (``portbench/collection_spans.py``)."""
from portbench import collection_spans


def read(record):
    means = collection_spans.split(record)
    return None if means is None else means["reads"]
