"""Sliding-window generator for long reads.

Exact reference semantics (c-core/window.c:13-51): window length
min(50·K, 100000); the next window backs up to cover a possibly split hit,
bounded by 4·K, informed by the last hit position the caller reports back.

The hit feedback makes windows of one (profile, sequence) pair sequential;
the scan pipeline keeps one cursor per pair and batches *across* pairs, so
device batches stay large while the per-pair semantics stay exact.

The port's own copy of deciphon_tpu/scan/window.py, kept equal in behaviour
(tests/test_torch_copies.py compares the two).
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

    def estimate_windows(self) -> int:
        """Expected window count assuming no hits (lhp stays -1): the
        scan pipeline's initial speculation depth, so a hit-free cursor
        scores its whole chain in one wave."""
        w = min(self.core_size * LENGTH_FACTOR, MAX_WINDOW)
        if self.seq_size <= w:
            return 1
        # hit-free stride: next start = stop + 1 - 4K (window.c:21-27)
        step = max(w + 1 - self.core_size * OVERLAP_FACTOR, 1)
        return 1 + -(-(self.seq_size - w) // step)

    # Snapshot/restore: the scan pipeline speculates windows ahead of the
    # last-hit feedback (windows are generated assuming no new hit) and
    # rewinds the cursor when a hit lands with a different last_hit_pos —
    # re-deriving the exact serial window walk of the reference.
    def state(self) -> tuple[int, int, int, int]:
        return (self.start, self.stop, self.idx, self.last_hit_pos)

    def restore(self, state: tuple[int, int, int, int]) -> None:
        self.start, self.stop, self.idx, self.last_hit_pos = state
