"""``device_idle``: the share of the profiled sub-window in which no
operation ran on the card (one minus the union of every device record over
the sub-window), in percent, averaged over the cards."""


def read(record):
    shares = [t.idle_share for t in record.traces if t.window_us > 0]
    return 100.0 * sum(shares) / len(shares) if shares else None
