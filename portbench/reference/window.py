"""Sliding-window generator for long reads.

Exact reference semantics (c-core/window.c:13-51): window length
min(50·K, 100000); the next window backs up to cover a possibly split hit,
bounded by 4·K, informed by the last hit position the caller reports back.

The hit feedback makes windows of one (profile, sequence) pair sequential;
the scan pipeline keeps one cursor per pair and batches *across* pairs, so
device batches stay large while the per-pair semantics stay exact.

The benchmark's frozen copy of the arithmetic of
deciphon_tpu/scan/window.py (and of deciphon_tpu_torch's copy of it); the reference never
imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_WINDOW = 100000
LENGTH_FACTOR = 50
OVERLAP_FACTOR = 4


@dataclass
class Window:
    idx: int
    start: int
    stop: int  # [start, stop)

    @property
    def length(self) -> int:
        return self.stop - self.start


class WindowCursor:
    """Iterates windows over one sequence for one profile core size."""

    def __init__(self, core_size: int, seq_size: int):
        self.core_size = core_size
        self.seq_size = seq_size
        self.start = -1
        self.stop = 0
        self.idx = -1
        self.last_hit_pos = -1  # window-relative

    def next(self) -> Window | None:
        if self.stop == self.seq_size:
            return None
        stop_miss = self.stop + 1
        start_miss = max(self.start + 1, self.start + self.last_hit_pos + 1)
        start_miss = max(start_miss, stop_miss - self.core_size * OVERLAP_FACTOR)
        self.start = start_miss
        self.stop = min(
            self.start + min(self.core_size * LENGTH_FACTOR, MAX_WINDOW),
            self.seq_size,
        )
        self.idx += 1
        # NOTE: last_hit_pos deliberately persists across windows until the
        # caller overwrites it — window.c:13-37 never resets it, and the
        # golden-checksum contract depends on that carry-over.
        return Window(self.idx, self.start, self.stop)

    def set_last_hit_position(self, pos: int) -> None:
        """pos is window-relative (c-core/thread.c:162)."""
        self.last_hit_pos = pos
