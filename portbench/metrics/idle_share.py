"""idle_share: the share of the window's wall in which the card ran no
kernel and no copy, in percent: 1 - (union of the device intervals of the
trace) / (the window span's length)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    busy = run.trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.trace.window_s)
