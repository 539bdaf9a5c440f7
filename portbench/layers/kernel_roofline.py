"""``kernel_roofline``: the update's least time over its device time, in
percent.

The least time of the update's work is the bytes of the inputs handed to it,
each read once, at the card's peak bandwidth (``common.PEAK_BYTES_PER_S``;
the state is resident and is not counted); the time taken is the device time
of every operation launched under the benchmark's ``update`` spans in the
profiled sub-window."""
from portbench import common


def read(record):
    per_update = record.extras.get("bytes_per_update")
    least = taken = 0.0
    for trace in record.traces:
        device_us = trace.span_device_us.get("update", [])
        least += len(device_us) * (per_update or 0) / common.PEAK_BYTES_PER_S
        taken += sum(device_us) / 1e6
    if not per_update or taken <= 0:
        return None
    return 100.0 * least / taken
