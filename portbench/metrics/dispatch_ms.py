"""dispatch_ms: the scheduler's host time a batch that forms the launch
classes and issues phase 1's launches (ScanMetrics walls `pack` and
`dispatch`, the blocking metadata copies included), summed over the
window's batches over their count."""


def read(run):
    if not run.batches:
        return None
    s = sum(b["walls"].get("pack", 0.0) + b["walls"].get("dispatch", 0.0)
            for b in run.batches)
    return 1e3 * s / len(run.batches)
