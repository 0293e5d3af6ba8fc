"""path_fill: the path kernel's (B2's) true cells over its padded cells,
in percent (ScanMetrics.bucket_cells, `path_` names: the survivors'
window length x 5 x K against the launched shape), over every B2 launch
of the window's batches."""

from portbench.program import records


def read(run):
    recs = records(run)
    if recs is None:
        return None
    true = padded = 0
    for m in recs:
        for name, (t, p, _) in m.bucket_cells.items():
            if name.startswith("path_"):
                true, padded = true + t, padded + p
    return 100.0 * true / padded if padded > 0 else None
