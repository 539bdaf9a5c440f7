"""``update_rest_ms``: the mean host time per keyed update outside the four
other parts (the ``keyed.update`` span less checks, host reads, row states and
scatter: the ids, the bundle loop, the lock, the states' commit and the
telemetry), from the program's host spans over the window's requests
(``portbench/host_spans.py``). The five parts sum to the ``keyed.update``
span."""
from portbench import host_spans


def read(record):
    return host_spans.read_ms(record, "rest")
