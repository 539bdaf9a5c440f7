"""``collection_members_ms``: the mean host time per eager collection update
of its members' own updates (``member_update`` spans: each member updated
alone, and each member's update from the shared deltas), less their checks
and host reads, from the program's host spans over the window's requests
(``portbench/collection_spans.py``)."""
from portbench import collection_spans


def read(record):
    return collection_spans.read_ms(record, "members")
