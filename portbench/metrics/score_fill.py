"""score_fill: the phase-1 launches' true cells over their padded cells,
in percent (ScanMetrics.bucket_cells, `bkt_` names: a launch's windows'
L x 5 x K against its launched shape), over every launch of the window's
batches."""

from portbench.program import records


def read(run):
    recs = records(run)
    if recs is None:
        return None
    true = padded = 0
    for m in recs:
        for name, (t, p, _) in m.bucket_cells.items():
            if name.startswith("bkt_"):
                true, padded = true + t, padded + p
    return 100.0 * true / padded if padded > 0 else None
