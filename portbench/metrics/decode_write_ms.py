"""decode_write_ms: the pipeline's host time a batch in hit segmentation,
codon/amino decode and product lines (ScanMetrics walls `phase2_decode`)
and in writing products.tsv (`write`), summed over the window's batches
over their count."""


def read(run):
    if not run.batches:
        return None
    s = sum(b["walls"].get("phase2_decode", 0.0) + b["walls"].get("write", 0.0)
            for b in run.batches)
    return 1e3 * s / len(run.batches)
