"""``collection_checks_ms``: the mean host time per eager collection update
of the input checks (``checks`` spans: ``utilities/checks.py`` and the
confusion matrix's label range, for each shared-update class and each member
updated alone), less the host reads inside them, from the program's host
spans over the window's requests (``portbench/collection_spans.py``)."""
from portbench import collection_spans


def read(record):
    return collection_spans.read_ms(record, "checks")
