"""score_gcups: cells scored in the repository's unit (L x 5 x K a
scored window, counted by yardstick.batch_cells) over the score kernels'
device seconds, in 1e9 a second."""

from portbench.yardstick import SCORE_RE


def read(run):
    if run.trace is None:
        return None
    dev = run.trace.seconds(SCORE_RE)
    if dev <= 0:
        return None
    return 5 * sum(b["cells"] for b in run.batches) / dev / 1e9
