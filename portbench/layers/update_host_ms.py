"""``update_host_ms``: the mean host time of one ``update`` call, with no
synchronize, from the benchmark's ``update`` spans over the traced window."""


def read(record):
    spans = record.spans.get("update")
    return 1e3 * sum(spans) / len(spans) if spans else None
