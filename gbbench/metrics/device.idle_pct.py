"""Share of the traced slice in which no operation (kernel, copy or memset)
ran on the card, in percent (the union of the trace's device intervals)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None  # nothing ran on a device: nothing to read
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
