"""launches_per_batch: the program's kernel launches a batch, all
wrappers together (ScanMetrics counts `launches`, the run's differences
of ops/viterbi.py LAUNCHES), summed over the window's batches over their
count."""

from portbench.program import records


def read(run):
    recs = records(run)
    if recs is None:
        return None
    return sum(sum(m.counts.get("launches", {}).values())
               for m in recs) / len(recs)
