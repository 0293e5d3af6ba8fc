"""score_roofline: the score kernels' least time over their device time,
in percent.  The least time of a batch is yardstick.score_least_seconds:
34 f32 operations a (position, node) cell of every window the scan
scores (yardstick.batch_cells, the benchmark's own count), every
profile's tables and the reads' codes read once, against the peaks; the
device time is the trace's, by kernel name (yardstick.SCORE_KERNELS)."""

from portbench.yardstick import SCORE_RE, score_least_seconds


def read(run):
    if run.trace is None:
        return None
    dev = run.trace.seconds(SCORE_RE)
    if dev <= 0:
        return None
    least = sum(score_least_seconds(b["cells"], run.core_sizes, b["nt"])
                for b in run.batches)
    return 100.0 * least / dev
