"""unspanned_ms: the host time a batch inside `Scanner.run` that no span
of the program covers: the `run` span's wall less the spans directly
inside it (ScanMetrics.unspanned_s, from the spans a profiler-recorded run
keeps), summed over the window's batches over their count."""

from portbench.program import records


def read(run):
    recs = records(run)
    if recs is None:
        return None
    free = [m.unspanned_s() for m in recs]
    if any(s is None for s in free):
        return None
    return 1e3 * sum(free) / len(recs)
