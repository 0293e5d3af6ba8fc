"""syncs_per_batch: the program's blocking transfers a batch (ScanMetrics
counts `syncs`: every device-to-host read, every host-to-device copy from
pageable memory), summed over the window's batches over their count."""

from portbench.program import records


def read(run):
    recs = records(run)
    if recs is None:
        return None
    return sum(m.counts.get("syncs", 0) for m in recs) / len(recs)
