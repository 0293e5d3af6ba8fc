"""Leveled logging + scan observability counters.

Parity: the reference's env-gated debug logging (c-core/loglevel.c:9-17,
DECIPHON_LOGLEVEL) and its integer progress metric; extended with the
throughput counters the accelerator builds need (cells scanned, windows scored,
GCUPS) — the reference has no profiling at all (SURVEY.md §5).

The port's own copy of deciphon_tpu/logging.py, kept equal in behaviour
(tests/test_torch_copies.py compares the two).  Beyond the copy: every
`ScanMetrics.timed` span also lands on torch.profiler's clock while a
profiler records (`deciphon.<name>`, and the run's in-memory span list),
the always-on per-run `counts` and `longest`, the transfers of a scan
(blocking: `to_host`, `to_device`; with no drain of the stream: `stage`,
`stage_host`, `read_staged`, `wait_event`), and `HISTORY`, the finished
runs.
"""

from __future__ import annotations

import contextvars
import logging
import os
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from itertools import count

import numpy as np
import torch

__all__ = ["get_logger", "ScanMetrics", "HISTORY", "timed", "to_host",
           "to_device", "stage", "stage_host", "read_staged", "wait_event",
           "profiling"]

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR,
           "off": logging.CRITICAL + 10}

# Finished runs' ScanMetrics, oldest first, as many as a worker serves in
# a long benchmark window many times over: a reader that kept only each
# run's walls lines its records up against the last of these.
HISTORY: deque = deque(maxlen=1024)

# The ScanMetrics of the run in progress in this thread (Scanner.run sets
# it): where the transfers count.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "deciphon_scan_metrics", default=None)
_RUN_IDS = count(1)
_OFF = nullcontext()


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


def profiling() -> bool:
    """Whether a torch.profiler records in this thread: the one switch
    that puts spans on the profiler's clock."""
    return torch.autograd._profiler_enabled()


class _Span:
    """One `ScanMetrics.timed` span.  Always: its wall into `walls` and
    `longest`.  While a profiler records: a `deciphon.<name>`
    record_function range, and (name, start_ns, end_ns, parent, run_id,
    wave) in the run's `spans` (perf_counter_ns, CLOCK_MONOTONIC on
    Linux; parent the index of the enclosing span there, or None; wave
    the one given, else the parent's)."""

    __slots__ = ("m", "name", "wave", "t0", "rf", "idx", "parent")

    def __init__(self, m: "ScanMetrics", name: str, wave):
        self.m, self.name, self.wave, self.rf = m, name, wave, None

    def __enter__(self):
        if profiling():
            m = self.m
            if m.spans is None:
                m.spans = []
            if m._open:
                self.parent, wave = m._open[-1]
                if self.wave is None:
                    self.wave = wave
            else:
                self.parent = None
            self.idx = len(m.spans)
            m.spans.append(None)  # closed in __exit__
            m._open.append((self.idx, self.wave))
            self.rf = torch.autograd.profiler.record_function(
                "deciphon." + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        m, name = self.m, self.name
        dt = (t1 - self.t0) * 1e-9
        m.walls[name] = m.walls.get(name, 0.0) + dt
        if dt > m.longest.get(name, -1.0):
            m.longest[name] = dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
            m._open.pop()
            m.spans[self.idx] = (name, self.t0, t1, self.parent, m.run_id,
                                 self.wave)
        return False


@dataclass
class ScanMetrics:
    """Throughput accounting for one scan run.

    Beyond the reference-parity counters, `walls` breaks the wall clock
    into pipeline phases (pack / dispatch / collect / phase2_* / decode /
    write) — the per-phase observability SURVEY §5 names a greenfield
    obligation, and the instrument that localizes host-vs-device time in
    the end-to-end scan.  Every wall is a `timed` span; while a
    torch.profiler records, the spans are also kept in `spans` and put on
    the profiler's clock.  `counts` and `longest` are always kept."""

    windows_scored: int = 0
    cells: int = 0  # L * 5 * K per scored (profile, window)
    pairs_batches: int = 0
    survivors: int = 0
    products: int = 0
    wasted_windows: int = 0  # speculated windows discarded by hit rewinds
    started: float = field(default_factory=time.perf_counter)
    walls: dict = field(default_factory=dict)
    # per-bucket (true_cells, padded_cells, dispatches) of every phase-1
    # launch (bkt_ names) and B2 launch (path_ names) — the fill diagnostic
    # that localizes padding waste per kernel tier
    bucket_cells: dict = field(default_factory=dict)
    # per run: syncs, d2h_bytes, h2d_bytes, staged, staged_bytes, rewalks,
    # launches (by LAUNCHES key), on the card alloc_retries,
    # device_mallocs, device_frees
    counts: dict = field(default_factory=dict)
    longest: dict = field(default_factory=dict)  # span -> its longest wall
    # (name, start_ns, end_ns, parent, run_id, wave) of each span while a
    # profiler records; None when none did
    spans: list | None = None
    run_id: int = field(default_factory=lambda: next(_RUN_IDS))
    _open: list = field(default_factory=list, repr=False)

    def add_window(self, length: int, core_size: int) -> None:
        self.windows_scored += 1
        self.cells += length * 5 * core_size

    def add_wall(self, phase: str, dt: float) -> None:
        self.walls[phase] = self.walls.get(phase, 0.0) + dt

    def add_bucket_cells(self, name: str, true_cells: int,
                         padded_cells: int) -> None:
        t, p, n = self.bucket_cells.get(name, (0, 0, 0))
        self.bucket_cells[name] = (t + true_cells, p + padded_cells, n + 1)

    def add_count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def timed(self, phase: str, wave: int | None = None) -> _Span:
        """A span: `with metrics.timed("collect"): ...`.  `wave` tags it
        (and the spans inside it) with the pipeline's wave index."""
        return _Span(self, phase, wave)

    @contextmanager
    def running(self, counters=None):
        """The scope of one run: the `run` span, this object as the
        thread's running ScanMetrics (where the transfers count), and an entry
        in HISTORY at the end.  `counters()`, if given, reads process-wide
        counts (numbers, or dicts of numbers) at the start and the end;
        their differences go into `counts` (a number added to what the run
        counted itself under its name)."""
        token = _ACTIVE.set(self)
        start = counters() if counters is not None else None
        try:
            with self.timed("run"):
                yield self
        finally:
            _ACTIVE.reset(token)
            if start is not None:
                for k, v in _delta(start, counters()).items():
                    self.counts[k] = (v if isinstance(v, dict)
                                      else self.counts.get(k, 0) + v)
            HISTORY.append(self)

    def unspanned_s(self) -> float | None:
        """Seconds of the `run` span that none of its child spans covers
        (from `spans`: None without them)."""
        run = self.spans[0] if self.spans else None
        if run is None or run[0] != "run":  # none, open, or begun mid-run
            return None
        held = sum(s[2] - s[1] for s in self.spans
                   if s is not None and s[3] == 0)
        return (run[2] - run[1] - held) * 1e-9

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


def _delta(a: dict, b: dict) -> dict:
    """b - a, key by key; dicts of numbers by their nonzero keys."""
    out = {}
    for k, v in b.items():
        if isinstance(v, dict):
            was = a.get(k, {})
            out[k] = {j: n - was.get(j, 0) for j, n in v.items()
                      if n != was.get(j, 0)}
        else:
            out[k] = v - a.get(k, 0)
    return out


def timed(metrics: ScanMetrics | None, phase: str):
    """`metrics.timed(phase)`, or nothing for a caller without ScanMetrics
    (a scorer used outside a Scanner)."""
    return _OFF if metrics is None else metrics.timed(phase)


def to_host(t):
    """A blocking device-to-host read of tensor `t`, as a numpy array.
    Every read on a scan's path comes here: counted in the running scan's
    ScanMetrics (`syncs`, `d2h_bytes`), with the host's wait for the card
    (span `wait`: the stream drains) timed apart from the copy (`copy`)."""
    m = _ACTIVE.get()
    if m is None:
        return t.cpu().numpy()
    m.add_count("syncs")
    m.add_count("d2h_bytes", t.numel() * t.element_size())
    if t.device.type == "cuda":
        with m.timed("wait"):
            torch.cuda.current_stream(t.device).synchronize()
    with m.timed("copy"):
        return t.cpu().numpy()


def to_device(device, *arrays) -> list:
    """Host numpy arrays -> tensors on `device`.  A copy from pageable
    memory returns once the device's stream has drained (PyTorch
    synchronises it), so in a scan each array is one of `syncs`, its bytes
    count in `h2d_bytes`, and the wait for the stream (`wait`) is timed
    apart from the copies (`copy`)."""
    m = _ACTIVE.get()
    if m is None:
        return [torch.from_numpy(a).to(device) for a in arrays]
    device = torch.device(device)
    m.add_count("syncs", len(arrays))
    m.add_count("h2d_bytes", sum(a.nbytes for a in arrays))
    if device.type == "cuda":
        with m.timed("wait"):
            torch.cuda.current_stream(device).synchronize()
    with m.timed("copy"):
        return [torch.from_numpy(a).to(device) for a in arrays]


# Each array of a staged upload starts on this byte boundary of the
# device buffer (the caching allocator's own blocks start on 512).
_STAGE_ALIGN = 256


def stage(device, *arrays) -> list:
    """Host numpy arrays -> tensors on the card `device`, with no wait for
    its stream: the arrays are copied into one pinned host buffer from
    PyTorch's caching host allocator (which reuses a block only after the
    copy that reads it has run), sent in one `non_blocking` copy on the
    device's current stream, and returned as typed views of the one
    device buffer.  The caller may overwrite its arrays once this returns.
    In a scan the upload counts in `staged` and its bytes in
    `staged_bytes` and `h2d_bytes`; it is not one of `syncs`."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    flat = host.numpy()
    for a, o in zip(arrays, offsets):
        flat[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    out = [dev[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
           .view(a.shape) for a, o in zip(arrays, offsets)]
    m = _ACTIVE.get()
    if m is not None:
        nbytes = sum(a.nbytes for a in arrays)
        m.add_count("staged")
        m.add_count("staged_bytes", nbytes)
        m.add_count("h2d_bytes", nbytes)
    return out


def wait_event(event) -> None:
    """The host's wait for one recorded CUDA event, before it reads what
    the transfers ahead of the event wrote: in a scan one of `syncs`,
    timed as `wait`."""
    m = _ACTIVE.get()
    if m is None:
        event.synchronize()
        return
    m.add_count("syncs")
    with m.timed("wait"):
        event.synchronize()


def stage_host(*tensors) -> tuple:
    """Card tensors on their way to the host, with no wait for the stream:
    each copied into pinned host memory with `non_blocking` on the current
    stream, and an event recorded after the copies; returns (host tensors,
    event), which `read_staged` reads.  In a scan their bytes count in
    `d2h_bytes`."""
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 .copy_(t, non_blocking=True) for t in tensors)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensors[0].device))
    m = _ACTIVE.get()
    if m is not None:
        m.add_count("d2h_bytes",
                    sum(t.numel() * t.element_size() for t in host))
    return host, done


def read_staged(tensors, event) -> list:
    """Numpy views of the pinned host tensors of `stage_host`, once its
    event has passed (`wait_event`: the host waits for those copies alone,
    not for the stream)."""
    wait_event(event)
    return [t.numpy() for t in tensors]
