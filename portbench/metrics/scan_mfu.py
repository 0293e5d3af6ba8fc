"""scan_mfu: the whole window's share of the card's peak, in percent: the
least time of the work the scans did on the card -- phase 1's cells and
tables (yardstick.score_least_seconds) and the windows of phase 2's lines
(yardstick.path_least_seconds) -- over the window's wall.  It bounds the
kernels' rooflines from above whatever kernel does the work."""

from portbench.yardstick import path_least_seconds, score_least_seconds


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    least = sum(score_least_seconds(b["cells"], run.core_sizes, b["nt"])
                for b in run.batches)
    least += sum(path_least_seconds(L, K) for L, K in run.path_windows)
    return 100.0 * least / run.window_s if least > 0 else None
