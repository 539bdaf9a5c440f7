"""``collection_shared_ms``: the mean host time per eager collection update
of the shared-update classes' deltas (``shared_update`` spans: each class's
canonicalization and its B1 or B2 launch), less their checks and host reads,
from the program's host spans over the window's requests
(``portbench/collection_spans.py``)."""
from portbench import collection_spans


def read(record):
    return collection_spans.read_ms(record, "shared")
