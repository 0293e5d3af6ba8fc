"""The program's own records of a run's batches: the ScanMetrics that
deciphon_tpu_torch.logging keeps of each finished `Scanner.run`
(`HISTORY`), lined up with the window's batches.

`records(run)` gives the last len(run.batches) of them, or None: where
the program keeps no such history (a version before it), and where those
records' walls are not the batches' walls (`Run.batches[i]["walls"]`,
copied after each batch's run) one to one."""

from __future__ import annotations


def records(run):
    if not run.batches:
        return None
    try:
        from deciphon_tpu_torch import logging as program_logging
    except ImportError:
        return None
    history = getattr(program_logging, "HISTORY", None)
    n = len(run.batches)
    if history is None or len(history) < n:
        return None
    last = list(history)[-n:]
    if any(getattr(m, "walls", None) != b["walls"]
           for m, b in zip(last, run.batches)):
        return None
    return last
