"""``compute_ms``: the mean wall time of ``compute()`` up to its values on
the host (the epoch's sync included, where there is one), from the
benchmark's ``compute`` spans over the traced window."""


def read(record):
    spans = record.spans.get("compute")
    return 1e3 * sum(spans) / len(spans) if spans else None
