"""The table of peaks, the kernels' families, and the work they must do.

Peaks of one H100 SXM from NVIDIA's data sheet: f32 outside the tensor
cores (an FMA counted as two operations, so adds and mins alone reach half
of it: the operation bound below is the generous one) and HBM3 bandwidth.

Operations a (position, profile node) cell, counted from the kernel bodies
(chip_smoke.py's CELL_OPS, copied): the score family 34 f32 adds and mins
(inner 3 + 2, contrib 1 + 1, icand 2 + 1, the five pushes of M and of I
5 + 4 each, then A, A - DDCUM, the prefix min, D, min(M, D) and the E
reduction); the path kernel 98 (per fragment length 4 match candidates of
2 adds + 1 compare and 2 insert candidates of 2 + 1, five lengths: 90;
the delete chain 5; E and its first index 3).  The special states are
O(1) a position and left out.

The work is counted by the benchmark from the scan's inputs, never from
padded launch shapes or the program's own counters, so it reads the same
whatever kernel does it: phase 1's windows are the benchmark's copy of
the window cursor's (reference/window.py) over each (read, profile) pair
with no hit fed back (a hit moves the next window's start back by at
most 4 K positions, and only after a hit), and phase 2's are the windows
of the lines the program wrote (a survivor that yields no line is traced
too and not counted: the path work is a lower bound).
"""

from __future__ import annotations

import re
from functools import lru_cache

from .reference.window import WindowCursor

PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
SCORE_OPS = 34
PATH_OPS = 98
TABLE_ROWS = 1364 + 9  # emission rows and transition rows of one node
BYTES_F32 = 4
CODE_BYTES = 20  # five int32 fragment codes a position

# kernel names, as they appear in the device trace (the identifiers of
# csrc/*.cu's __global__ functions)
SCORE_KERNELS = ("score_pairs_kernel", "score_large_kernel",
                 "score_chained_kernel", "score_packed_kernel",
                 "score_packed_chained_kernel")
PATH_KERNELS = ("path_kernel",)


def _pattern(names) -> re.Pattern:
    """A kernel's name, demangled (`void path_kernel<true>(...)`) or
    mangled (`_Z11path_kernelILb1EEv...`: the length, then the name)."""
    plain = r"(?<![A-Za-z_])(?:" + "|".join(names) + r")(?![A-Za-z0-9_])"
    mangled = r"(?<![0-9])(?:" + "|".join(f"{len(n)}{n}" for n in names) + ")"
    return re.compile(f"{plain}|{mangled}")


SCORE_RE = _pattern(SCORE_KERNELS)
PATH_RE = _pattern(PATH_KERNELS)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger bound."""
    return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)


@lru_cache(maxsize=None)
def pair_cells(K: int, L: int) -> int:
    """(position, node) cells of one read of L nt against one profile of
    core size K: the lengths of the windows the cursor gives, times K."""
    cur, n = WindowCursor(K, L), 0
    while (w := cur.next()) is not None:
        n += w.length
    return n * K


def batch_cells(core_sizes, read_lengths) -> int:
    """Phase 1's (position, node) cells of one batch."""
    return sum(pair_cells(K, L) for K in core_sizes for L in read_lengths)


def score_least_seconds(cells: int, core_sizes, batch_nt: int) -> float:
    """Phase 1 of one batch: 34 operations a (position, node) cell
    (`batch_cells`), every profile's tables read once, and the reads'
    fragment codes once."""
    ops = SCORE_OPS * cells
    nbytes = (sum(core_sizes) * TABLE_ROWS * BYTES_F32
              + batch_nt * CODE_BYTES)
    return least_seconds(ops, nbytes)


def path_least_seconds(length: int, K: int) -> float:
    """One traced window: its cells, its profile's tables and codes read
    once, and its trellis words (one a node and one special word a
    position) written once."""
    ops = PATH_OPS * length * K
    nbytes = (K * TABLE_ROWS * BYTES_F32 + length * CODE_BYTES
              + length * (K + 1) * BYTES_F32)
    return least_seconds(ops, nbytes)
