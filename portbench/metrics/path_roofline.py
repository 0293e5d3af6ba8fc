"""path_roofline: the path kernel's (B2's) least time over its device
time, in percent.  The least time is yardstick.path_least_seconds of the
window of every line the program wrote in the window (98 f32 operations
a cell, the trellis words as output bytes; survivors that yield no line
are left out, so this is a lower bound); the device time is the trace's,
by kernel name."""

from portbench.yardstick import PATH_RE, path_least_seconds


def read(run):
    if run.trace is None or not run.path_windows:
        return None
    dev = run.trace.seconds(PATH_RE)
    if dev <= 0:
        return None
    least = sum(path_least_seconds(L, K) for L, K in run.path_windows)
    return 100.0 * least / dev
