"""Leveled logging + scan observability counters.

Parity: the reference's env-gated debug logging (c-core/loglevel.c:9-17,
DECIPHON_LOGLEVEL) and its integer progress metric; extended with the
throughput counters the accelerator builds need (cells scanned, windows scored,
GCUPS) — the reference has no profiling at all (SURVEY.md §5).

The port's own copy of deciphon_tpu/logging.py, kept equal in behaviour
(tests/test_torch_copies.py compares the two).
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = ["get_logger", "ScanMetrics"]

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR,
           "off": logging.CRITICAL + 10}


def get_logger(name: str = "deciphon_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        level = os.environ.get("DECIPHON_LOGLEVEL", "warning").lower()
        logger.setLevel(_LEVELS.get(level, logging.WARNING))
    return logger


@dataclass
class ScanMetrics:
    """Throughput accounting for one scan run.

    Beyond the reference-parity counters, `walls` breaks the wall clock
    into pipeline phases (pack / dispatch / collect / phase2_* / decode /
    write) — the per-phase observability SURVEY §5 names a greenfield
    obligation, and the instrument that localizes host-vs-device time in
    the end-to-end scan."""

    windows_scored: int = 0
    cells: int = 0  # L * 5 * K per scored (profile, window)
    pairs_batches: int = 0
    survivors: int = 0
    products: int = 0
    wasted_windows: int = 0  # speculated windows discarded by hit rewinds
    started: float = field(default_factory=time.perf_counter)
    walls: dict = field(default_factory=dict)
    # sync-debug only: per-bucket (true_cells, padded_cells, dispatches) —
    # the fill diagnostic that localizes padding waste per kernel tier
    bucket_cells: dict = field(default_factory=dict)

    def add_window(self, length: int, core_size: int) -> None:
        self.windows_scored += 1
        self.cells += length * 5 * core_size

    def add_wall(self, phase: str, dt: float) -> None:
        self.walls[phase] = self.walls.get(phase, 0.0) + dt

    def add_bucket_cells(self, name: str, true_cells: int,
                         padded_cells: int) -> None:
        t, p, n = self.bucket_cells.get(name, (0, 0, 0))
        self.bucket_cells[name] = (t + true_cells, p + padded_cells, n + 1)

    @contextmanager
    def timed(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_wall(phase, time.perf_counter() - t0)

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.started

    @property
    def gcups(self) -> float:
        dt = self.elapsed
        return self.cells / dt / 1e9 if dt > 0 else 0.0

    def summary(self) -> dict:
        return {
            "windows_scored": self.windows_scored,
            "cells": self.cells,
            "pairs_batches": self.pairs_batches,
            "survivors": self.survivors,
            "products": self.products,
            "wasted_windows": self.wasted_windows,
            "elapsed_s": round(self.elapsed, 3),
            "gcups": round(self.gcups, 3),
            "walls": {k: round(v, 4) for k, v in sorted(self.walls.items())},
        }
