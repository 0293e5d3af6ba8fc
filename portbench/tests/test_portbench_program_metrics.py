"""The readers of the program's own records (portbench/program.py, and
each metric that reads through it) on the tiny cell, traced, on the CPU:
each reads a number from a run whose history lines up with its batches,
and None from one whose does not."""

from __future__ import annotations

import collections
import copy

import pytest

import portbench.run as prun

NEW = ("unspanned_ms", "host_wait_ms", "syncs_per_batch",
       "launches_per_batch", "score_fill", "path_fill")
BIG_SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def traced():
    """(run, result, the program's history right after the run) of one
    traced run of the tiny cell with the new metrics as its per-layer
    ones."""
    from deciphon_tpu_torch import logging as program_logging

    from .conftest import TINY

    spec = copy.deepcopy(TINY)
    spec["per_layer"] = [{"name": n, "unit": "x"} for n in NEW]
    seen = []
    read = prun.read_metric

    def keep(name, run):
        seen.append(run)
        return read(name, run)

    prun.read_metric = keep
    try:
        out = prun.run_cell(spec, BIG_SEED, 0.01, True, device="cpu")
    finally:
        prun.read_metric = read
    return seen[0], out, collections.deque(program_logging.HISTORY)


@pytest.fixture
def history(traced, monkeypatch):
    """The program's history as the traced run left it."""
    from deciphon_tpu_torch import logging as program_logging

    monkeypatch.setattr(program_logging, "HISTORY", traced[2])
    return traced[2]


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_a_number(traced, history, name):
    run, out, _ = traced
    assert run.batches
    value = out["metrics"][name]["value"]
    assert isinstance(value, float) and value >= 0
    assert prun.read_metric(name, run) == value


@pytest.mark.parametrize("name", NEW)
def test_reader_refuses_a_history_out_of_line(traced, history, name):
    """One batch fewer (the last records are then the batches shifted by
    one), one batch's walls altered, or more batches than the history
    holds: None."""
    run = traced[0]
    shifted = copy.copy(run)
    shifted.batches = run.batches[:-1] or [{"walls": {"run": -1.0}}]
    altered = copy.copy(run)
    altered.batches = [dict(b) for b in run.batches]
    altered.batches[-1]["walls"] = dict(altered.batches[-1]["walls"],
                                        run=-1.0)
    longer = copy.copy(run)
    longer.batches = run.batches * (len(history) // len(run.batches) + 1)
    for bad in (shifted, altered, longer):
        assert prun.read_metric(name, bad) is None


def test_no_history_no_number(traced, monkeypatch):
    """A program that keeps no history (one before it did) gives None and
    raises nothing."""
    from deciphon_tpu_torch import logging as program_logging

    monkeypatch.delattr(program_logging, "HISTORY")
    for name in NEW:
        assert prun.read_metric(name, traced[0]) is None
