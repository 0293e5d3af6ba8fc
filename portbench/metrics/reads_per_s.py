"""reads_per_s: reads of every batch the window completed, over the
window's wall (host clock; each batch ends in torch.cuda.synchronize)."""


def read(run):
    return run.reads / run.window_s if run.window_s > 0 else None
