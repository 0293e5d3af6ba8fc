"""host_wait_ms: the time a batch the host was blocked on the card, the
program's `wait` spans (before each blocking transfer the host waits for
the stream to drain), summed over the window's batches over their
count."""

from portbench.program import records


def read(run):
    recs = records(run)
    if recs is None:
        return None
    return 1e3 * sum(m.walls.get("wait", 0.0) for m in recs) / len(recs)
