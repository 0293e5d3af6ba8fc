"""peak_gib: torch.cuda.max_memory_allocated() over the window (the peak
is reset after the warm-up), in GiB: what bounds the database a card
holds."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes > 0 else None
