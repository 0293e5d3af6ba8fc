"""Batch scheduler: ragged (profile, window) pairs -> kernel launches.

Counterpart of deciphon_tpu/scan/scheduler.py on one device.  The host
helpers are the port's own copies, equal in behaviour (PairItem,
build_batches, bucket_arrays, bucket_arrays_meta, next_pow2, prev_pow2,
quantize_nlb, _pad_len (the reference pipeline's phase-2 group length),
_mass_p90, chunk_sizes, pad_groups, NCHUNK, _Bucket, _ChainChunk,
_PackedChainChunk, HBMLedger, _lpt_pack); what touches the device is
written for torch:

  * DeviceSeqCodes — the scan-resident START-indexed code table, built on
    the device from 1 byte/nt of uploaded bases;
  * PairScorer — one common-Kp table stack, kept on the host and placed
    on the device at first use (or per wave, when the capacity ledger
    streams it); phase-1 dispatch through the chain tier (B3) with its
    gang (B5, or B4m for streamed tables) and carry (B8) over-cap tiers
    and the classic rung buckets (B1), or, for an `hbm_table` scorer (the
    large-K tier, Kp > 5120), classic buckets on B4 alone; phase-2
    trellis + traceback (B2 + walk);
  * PackedPairScorer — one seg-need class of small-K profiles, NSEG side
    by side on one lane plane: whole-read windows through the packed
    chain tier (B7) or, under DECIPHON_NO_CHAIN=1, the packed rung tier
    (B6); everything else, and phase 2, through an inner PairScorer;
  * BucketedPairScorer — profiles partitioned into packed classes, plain
    Kp buckets and large-K buckets, one scorer each, one host transfer per
    phase-1 wave; a capacity ledger (HBMLedger) keeps the tables that fit
    the device budget resident and streams the rest host->device per
    wave; phase 2 holds its trellis bytes in flight under a bound;
  * TorchPairScorer — the lax.scan engine's counterpart (ops/engine.py
    scan_scores, plain PyTorch, no score kernel), group by group, with
    the reference pipeline's generic phase 2 (viterbi_path_batch + the
    device walk).

Environment switches, read where the reference reads them:
DECIPHON_NO_CHAIN=1 sends every window to the classic buckets (packed
windows to B6); DECIPHON_CHAIN_SEG=1 sends over-cap windows to carry
segments instead of the gang; DECIPHON_HBM_BUDGET (bytes) sets the
ledger's table budget; DECIPHON_SYNC_DEBUG=1 waits for each phase-1
launch of the chain, carry, gang, classic, packed and packed-chain tiers
and records its wall and its true and padded cells under the reference's
bucket name (`_bucket_ledger`), and DECIPHON_FILL_DEBUG then prints a
FILL line for each chain and carry launch.

Every scorer holds an explicit torch device; nothing falls back to the
CPU.  Profiles beyond the reference's K = 16384 raise.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..frame import FRAG_OFFSETS
from ..logging import get_logger
from ..ops import viterbi as vk
from ..ops.costs import ViterbiCosts
from ..ops.engine import scan_scores
from ..ops.tables import (common_kp, round_up, stack_tables,
                          stack_tables_packed)
from ..ops.traceback import assemble_path_entries, fetch_steps, walk
from ..ops.viterbi_torch import viterbi_path_batch
from ..xtrans import xtrans_cost_vector
from .window import Window

W = 8  # default windows per group (scorers may choose wider groups)


def _sync_debug() -> bool:
    """Re-read per dispatch, so that a caller can switch the bucket
    ledgers on and off between scans of one process."""
    return os.environ.get("DECIPHON_SYNC_DEBUG", "").lower() not in (
        "", "0", "false")


def _bucket_ledger(metrics, alt, name: str, true_cells: int,
                   padded_cells: int) -> None:
    """DECIPHON_SYNC_DEBUG: wait for one enqueued phase-1 launch (by
    reading its `alt` plane; a shard's part after its stream's event) and
    record its wall and its true and padded cells under `name`."""
    t0 = time.perf_counter()
    fetch_planes([alt])
    metrics.add_wall(name, time.perf_counter() - t0)
    metrics.add_bucket_cells(name, true_cells, padded_cells)


# Table placements of streamed scorers (PairScorer.stream_tables), counted
# where they are enqueued: every placement, its bytes, and how many of them
# were for phase 2 (a streamed scorer's survivors place its tables once
# more for the path kernel).  On the CPU a placement is the host tensor
# itself; on the card it is a host->device copy.
UPLOADS = {"uploads": 0, "bytes": 0, "phase2": 0}


def reset_uploads() -> None:
    for k in UPLOADS:
        UPLOADS[k] = 0


_COPY_STREAMS: dict = {}  # device -> the side stream of table uploads


def _upload(host: tuple, device: torch.device) -> tuple:
    """Copy pinned host tensors to the card on a side stream, so that a
    wave's upload overlaps the kernels already queued (a copy on the
    compute stream would wait behind them).  The compute stream waits for
    the copy before any later launch, and `record_stream` keeps the
    caching allocator from reusing the copies' memory until the compute
    stream's work on them is done: dropping the last reference right
    after the launches are enqueued is then safe."""
    compute = torch.cuda.current_stream(device)
    side = _COPY_STREAMS.get(device)
    if side is None:
        side = _COPY_STREAMS[device] = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        out = tuple(t.to(device, non_blocking=True) for t in host)
        done = torch.cuda.Event()
        done.record(side)
    compute.wait_event(done)
    for t in out:
        t.record_stream(compute)
    return out


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def prev_pow2(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _mass_p90(sorted_blks: np.ndarray) -> int:
    """Smallest window size covering >= 90% of total BLOCK mass.

    The chain cap must cover the windows that carry the compute, not the
    windows that are numerous: a COUNT percentile pinned the cap below
    the dominant window size whenever many short consensus reads shared
    a wave with fewer long read-sized windows, which
    pushed the main mass onto the classic fallback."""
    cum = np.cumsum(sorted_blks)
    i = int(np.searchsorted(cum, 0.9 * cum[-1]))
    return int(sorted_blks[min(i, len(sorted_blks) - 1)])


# Geometric ladder for padded l-block counts: ratio ~1.25 bounds padding
# waste at 25% (power-of-two padding wasted up to 2x compute on long
# windows) while keeping the compiled-shape space small — 37 rungs cover
# NLB 1..4200 (window cap 100 knt / kappa 40 = 2500 blocks).
_NLB_LADDER: list[int] = []
_v = 1.0
while _v <= 4200:
    r = int(-(-_v // 1))
    if not _NLB_LADDER or r > _NLB_LADDER[-1]:
        _NLB_LADDER.append(r)
    _v *= 1.25


def quantize_nlb(n: int) -> int:
    """Smallest ladder rung >= n."""
    for r in _NLB_LADDER:
        if r >= n:
            return r
    return n


class PairItem:
    """One scheduled window with its origin coordinates.

    `codes` (the (len, 5) END-indexed window fragment codes) is computed
    lazily from the origin sequence: the device-resident scoring path
    never touches it (it slices the scan-global code array by `gstart`),
    so only LRT survivors and host-side engines pay the O(L) precompute.
    """

    __slots__ = ("p_idx", "s_idx", "win", "multi_hits", "hmmer3_compat",
                 "seq", "gstart", "_codes", "post_state", "valid",
                 "dispatched")

    def __init__(self, p_idx: int, s_idx: int, win: Window,
                 multi_hits: bool, hmmer3_compat: bool,
                 codes: np.ndarray | None = None, seq=None,
                 gstart: int = -1):
        self.p_idx = p_idx
        self.s_idx = s_idx
        self.win = win
        self.multi_hits = multi_hits
        self.hmmer3_compat = hmmer3_compat
        self.seq = seq
        self.gstart = gstart
        self._codes = codes
        # speculation bookkeeping (scan/pipeline.py): the cursor state
        # right after this window was generated, whether the window is
        # still part of the serial walk, and whether a wave carries it
        self.post_state = None
        self.valid = True
        self.dispatched = False

    @property
    def codes(self) -> np.ndarray:
        if self._codes is None:
            self._codes = self.seq.window_codes(self.win.start, self.win.stop)
        return self._codes

    @property
    def xt(self) -> np.ndarray:
        return xtrans_cost_vector(self.multi_hits, self.hmmer3_compat,
                                  self.win.length)



def canonical_device(device: torch.device | str) -> torch.device:
    """`device` with its index: a bare "cuda" names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def start_codes_compute(b8: torch.Tensor) -> torch.Tensor:
    """(T,) int8 bases in [0, 4) -> (T, 5) int32 START-indexed codes: row
    p, column t-1 is FRAG_OFFSETS[t-1] + sum_i bases[p+i] * 4^(t-1-i).
    Rows whose fragment runs past T wrap around (never consumed)."""
    b = b8.to(torch.int32)
    cols = []
    for t in range(1, 6):
        v = torch.zeros_like(b)
        for i in range(t):
            v = v * 4 + torch.roll(b, -i)
        cols.append(FRAG_OFFSETS[t - 1] + v)
    return torch.stack(cols, dim=1).contiguous()


class DeviceSeqCodes:
    """Scan-resident START-indexed fragment codes, uploaded once per scan.

    Every sequence's bases are concatenated (1 byte/nt crosses to the
    device) and the (Tpad, 5) int32 code table is derived on the device.
    Scoring launches then name windows by their row offset (`gstart`).
    Fragments crossing a sequence boundary are only read for DP positions
    past a window's end, which no kernel captures."""

    ROW_QUANTUM = 1 << 16  # pad T to quantized sizes
    # Tail margin >= the largest padded window block; the port's kernels
    # clamp each row, so it only keeps the layout identical to the
    # reference's (whose slice gather clamps the slice offset).
    TAIL_MARGIN = 1 << 18

    def __init__(self, sequences, device: torch.device | str):
        self.offsets: list[int] = []
        total = 0
        parts = []
        for s in sequences:
            self.offsets.append(total)
            parts.append(s.symbols)
            total += s.size
        tpad = (-(-(max(total, 1) + self.TAIL_MARGIN) // self.ROW_QUANTUM)
                * self.ROW_QUANTUM)
        host = np.zeros((tpad,), np.int8)
        if parts:
            host[:total] = np.concatenate(parts)
        self.total = total
        self.dev = start_codes_compute(torch.from_numpy(host).to(device))
        # pad slots point past every real row (their length is 0)
        self.pad_start = tpad - 1
        self._copies: dict[torch.device, torch.Tensor] = {}

    def gstart(self, s_idx: int, win_start: int) -> int:
        return self.offsets[s_idx] + win_start

    def on(self, device: torch.device | str) -> torch.Tensor:
        """The code table on `device`: `dev` itself on its own device, else
        one copy a device, made at first use and shared by every scorer
        of the scan that holds this object."""
        device = canonical_device(device)
        if device == self.dev.device:
            return self.dev
        copy = self._copies.get(device)
        if copy is None:
            copy = self._copies[device] = self.dev.to(device)
        return copy


@dataclass
class _Bucket:
    nlb: int
    groups: list[list[PairItem]]
    w: int = W


@dataclass
class _ChainChunk:
    """Result-mapping for one chained kernel call: groups[gi][wi] is the
    ordered window chain of slot wi of pair gi (scores come back as
    (N, W, C) arrays indexed the same way)."""

    groups: list  # [gi][wi] -> list[PairItem]


@dataclass
class _PackedChainChunk:
    """Result-mapping for one packed-chained kernel call:
    groups[gi][wi][ci] is the [(segment, item), ...] fan-out of chain
    window ci of slot wi of pack-group gi (scores come back as
    (N, W, NSEG, C) arrays)."""

    groups: list  # [gi][wi][ci] -> list[(segment, PairItem)]


# Groups per kernel call: full chunks use this fixed leading dim (one
# compiled program covers most of the work), the remainder pads to a
# power of two (few small shapes) — the compiled-shape budget that keeps
# the cold wall bounded.
NCHUNK = 64


def chunk_sizes(n: int) -> list[int]:
    """Decompose a group count into chunks padding to {NCHUNK, 8, 1}.

    Every kernel call's leading dim (after pad_groups) is then one of
    exactly THREE values, so the compiled-program count stays flat
    regardless of workload shape (free-form power-of-two tails multiplied
    the cold compile wall).  A 2..7-group remainder ships as ONE chunk
    padded to N=8 (pad pairs carry length 0 and are near-free) instead of
    spraying per-call dispatch latency over N=1 calls."""
    out = []
    while n >= NCHUNK:
        out.append(NCHUNK)
        n -= NCHUNK
    while n >= 8:
        out.append(8)
        n -= 8
    if n:
        out.append(n)
    return out


def pad_groups(n: int) -> int:
    """Padded leading dim for an n-group chunk: one of {1, 8, NCHUNK}."""
    if n <= 1:
        return max(n, 1)
    return 8 if n <= 8 else NCHUNK


def build_batches(items: list[PairItem], kappa: int, w: int = W,
                  nlb_floor: int = 1) -> list[_Bucket]:
    """Bucket items by padded-length rung, group per profile into w-slots.

    The group width adapts PER (length-rung, profile): long-window rungs
    typically hold 1-2 windows per profile, and padding those up to the
    scorer-wide width wastes most of the launch (a 100 knt window group
    with 2 real slots of 32 is 94% padding).  `w`
    caps the width; each bucket carries the width its groups were built
    with.  `nlb_floor` merges sub-floor rungs into one bucket — short
    reads otherwise spray one near-free kernel call per (rung, scorer),
    and per-call dispatch latency, not compute, dominates those."""
    per: dict[tuple[int, int], list[PairItem]] = {}
    for it in items:
        nlb = max(nlb_floor,
                  quantize_nlb(max(1, -(-it.win.length // kappa))))
        per.setdefault((nlb, it.p_idx), []).append(it)

    buckets: dict[tuple[int, int], _Bucket] = {}
    for (nlb, p_idx) in sorted(per):
        wins = per[(nlb, p_idx)]
        wg = max(8, min(w, next_pow2(len(wins))))
        b = buckets.setdefault((nlb, wg), _Bucket(nlb=nlb, groups=[], w=wg))
        for i in range(0, len(wins), wg):
            b.groups.append(wins[i:i + wg])

    out = []
    for key in sorted(buckets):
        b = buckets[key]
        i = 0
        for size in chunk_sizes(len(b.groups)):
            out.append(_Bucket(nlb=b.nlb, groups=b.groups[i:i + size],
                               w=b.w))
            i += size
    return out


def bucket_arrays(bucket: _Bucket, kappa: int, mode: str = "raw",
                  w: int | None = None):
    """Assemble padded host inputs for one bucket.

    Returns (pidx (N,), xts (N,w,16), lens (N,w,1),
    ck (N,NLB,kappa,5,w) | None, codes (N,w,Lk,5) | None) with
    N = pad_groups(len(groups)); pad pairs have length 0 everywhere.
    "raw" (the lax.scan scorer) builds only the duration-major END-indexed
    `codes`, "pending" only the START-indexed `ck`.  The reference's other
    modes are TPU code layouts of the grid kernel, which the port does not
    have."""
    if mode not in ("raw", "pending"):
        raise ValueError(f"bucket_arrays: mode {mode!r} (the port builds "
                         "'raw' and 'pending')")
    w = bucket.w if w is None else w
    n = len(bucket.groups)
    N = pad_groups(n)
    NLB = bucket.nlb
    Lk = NLB * kappa

    pidx = np.zeros((N,), np.int32)
    xts = np.zeros((N, w, 16), np.float32)
    lens = np.zeros((N, w, 1), np.int32)
    for gi, g in enumerate(bucket.groups):
        pidx[gi] = g[0].p_idx
        for wi, it in enumerate(g):
            xts[gi, wi, :13] = it.xt
            lens[gi, wi, 0] = it.win.length

    if mode == "raw":
        codes = np.zeros((N, w, Lk, 5), np.int32)
        for gi, g in enumerate(bucket.groups):
            for wi, it in enumerate(g):
                codes[gi, wi, : it.win.length] = it.codes
        return pidx, xts, lens, None, codes

    ck = np.zeros((N, NLB, kappa, 5, w), np.int32)
    vt = ck.reshape(N, Lk, 5, w)
    # start-indexed in place: vt[l, t0] = end-codes[l + t0, t0]
    for gi, g in enumerate(bucket.groups):
        for wi, it in enumerate(g):
            L = it.win.length
            for t0 in range(5):
                vt[gi, : L - t0, t0, wi] = it.codes[t0:, t0]
    return pidx, xts, lens, ck, None


def bucket_arrays_meta(bucket: _Bucket, dev_codes: DeviceSeqCodes):
    """Metadata-only bucket assembly for the device-side packing path.

    Returns (pidx (N,), xts (N,w,16), lens (N,w,1), starts (N,w)) — a few
    KB per round instead of the materialized code blocks, which the
    fused kernel jit gathers on device from `dev_codes`."""
    w = bucket.w
    n = len(bucket.groups)
    N = pad_groups(n)
    pidx = np.zeros((N,), np.int32)
    xts = np.zeros((N, w, 16), np.float32)
    lens = np.zeros((N, w, 1), np.int32)
    starts = np.full((N, w), dev_codes.pad_start, np.int32)
    for gi, g in enumerate(bucket.groups):
        pidx[gi] = g[0].p_idx
        for wi, it in enumerate(g):
            xts[gi, wi, :13] = it.xt
            lens[gi, wi, 0] = it.win.length
            starts[gi, wi] = it.gstart
    return pidx, xts, lens, starts



def _tensors(device, *arrays):
    """Host metadata of one launch -> device tensors (a few KB)."""
    return [torch.from_numpy(a).to(device) for a in arrays]


class ShardedPlane:
    """A phase-1 output split along its leading dim into contiguous parts,
    each on the device of its shard (parallel/multidevice.py), with the
    event its shard's stream recorded after the launch (None on the CPU).
    Rows past the wave's own (the shards' pad rows) come last."""

    __slots__ = ("parts", "events")

    def __init__(self, parts: list, events: list):
        self.parts, self.events = parts, events

    @property
    def shape(self) -> tuple:
        return (sum(p.shape[0] for p in self.parts),
                *self.parts[0].shape[1:])


def fetch_planes(planes: list) -> list[np.ndarray]:
    """Host copies of device planes (tensors or ShardedPlanes): one
    transfer a device, every part on it concatenated there.  A shard's
    part is read after its stream's event."""
    parts: list[tuple[torch.Tensor, object]] = []  # every plane's parts
    spans = []  # [first, stop) of each plane's parts
    for a in planes:
        first = len(parts)
        if isinstance(a, ShardedPlane):
            parts.extend(zip(a.parts, a.events))
        else:
            parts.append((a, None))
        spans.append((first, len(parts)))
    by_dev: dict[torch.device, list[int]] = {}
    for i, (t, _) in enumerate(parts):
        by_dev.setdefault(t.device, []).append(i)
    host: list = [None] * len(parts)
    for dev, idx in by_dev.items():
        for i in idx:
            if parts[i][1] is not None:
                torch.cuda.current_stream(dev).wait_event(parts[i][1])
        flat = torch.cat([parts[i][0].reshape(-1) for i in idx]).cpu().numpy()
        pos = 0
        for i in idx:
            t = parts[i][0]
            host[i] = flat[pos:pos + t.numel()].reshape(t.shape)
            pos += t.numel()
    return [host[a] if b == a + 1 else np.concatenate(host[a:b])
            for a, b in spans]


def _lpt_pack(wins: list[tuple[PairItem, int]], nslots: int,
              cap: float, cmax: float) -> list[list]:
    """Least-loaded (LPT) bin packing of (item, blocks) into slots.

    Starts with `nslots` empty slots and opens extra ones when no
    slot satisfies the (cap blocks, cmax windows) bounds; returns
    non-empty slots as [(items, load_blocks)]."""
    slots: list[list[PairItem]] = [[] for _ in range(nslots)]
    loads = [0] * nslots
    for it, b in wins:
        best = -1
        for i in range(len(slots)):
            if (loads[i] + b <= cap and len(slots[i]) < cmax
                    and (best < 0 or loads[i] < loads[best])):
                best = i
        if best < 0:
            slots.append([])
            loads.append(0)
            best = len(slots) - 1
        slots[best].append(it)
        loads[best] += b
    return [(s, l) for s, l in zip(slots, loads) if s]


class _HostTables:
    """Profile tables held on the host and placed on the device at first
    use: `table_bytes` counts the host tensors, so the capacity ledger
    plans before anything is placed.  A streamed holder
    (`set_streaming(True)`, the ledger's choice for tables past the device
    budget) places them per wave instead, from pinned host memory on the
    card, and drops them with `release_tables()` once a wave's launches
    are enqueued."""

    def __init__(self, device: torch.device | str,
                 tables_host: torch.Tensor, tvecs_host: torch.Tensor):
        self.device = torch.device(device)
        self._tables_host, self._tvecs_host = tables_host, tvecs_host
        self._tables_cache: tuple | None = None  # (tables, tvecs) placed
        self.stream_tables = False

    def table_bytes(self) -> int:
        """Bytes of the emission/transition tables (host tensors)."""
        return (self._tables_host.numel() + self._tvecs_host.numel()) * 4

    def _place_tables(self) -> tuple:
        return self._place_on(self.device)

    def _place_on(self, device: torch.device) -> tuple:
        """(tables, tvecs) on `device`: a resident copy, or a streamed
        upload (counted in UPLOADS)."""
        host = (self._tables_host, self._tvecs_host)
        if not self.stream_tables:
            return tuple(t.to(device) for t in host)
        UPLOADS["uploads"] += 1
        UPLOADS["bytes"] += sum(t.numel() * 4 for t in host)
        if device.type != "cuda":
            return host
        return _upload(host, device)

    @property
    def tables(self) -> torch.Tensor:
        if self._tables_cache is None:
            self._tables_cache = self._place_tables()
        return self._tables_cache[0]

    @property
    def tvecs(self) -> torch.Tensor:
        if self._tables_cache is None:
            self._tables_cache = self._place_tables()
        return self._tables_cache[1]

    def release_tables(self) -> None:
        """Streamed mode: drop the device tables once a wave's launches
        are enqueued (the allocator frees them when those have run)."""
        if self.stream_tables:
            self._tables_cache = None

    def set_streaming(self, on: bool) -> None:
        """Stream the tables per wave (on) or keep them resident; on the
        card a streamed holder's host tables are pinned, for asynchronous
        copies."""
        self.stream_tables = on
        self._tables_cache = None
        if on and self.device.type == "cuda":
            self._tables_host = self._tables_host.pin_memory()
            self._tvecs_host = self._tvecs_host.pin_memory()


def dispatch_paths_bounded(launches, bound: int, metrics=None) -> list:
    """Run phase-2 path launches, given as (trellis bytes, launch) pairs,
    with at most `bound` trellis bytes in flight: before a launch that
    would pass it, the oldest launches are collected early (the reference
    pipeline's group loop), and their results ride along as one dict
    {id(item) -> (sids, sizes)} among the returned un-fetched entries.  A
    launch alone may pass the bound."""
    inflight: list[tuple] = []  # (entry, trellis bytes)
    held = 0
    early: dict[int, tuple] = {}
    for nbytes, launch in launches:
        while inflight and held + nbytes > bound:
            old, old_bytes = inflight.pop(0)
            t0 = time.perf_counter()
            assemble_path_entries([old], fetch_steps([old]), early)
            del old  # its trellis is free before the launch
            if metrics is not None:
                metrics.add_wall("phase2_collect", time.perf_counter() - t0)
            held -= old_bytes
        inflight.append((launch(), nbytes))
        held += nbytes
    entries: list = [e for e, _ in inflight]
    if early:
        entries.append(early)
    return entries


class PairScorer(_HostTables):
    """Scores scheduled pairs of one table stack with the port's kernels.

    Phase 1 ships per launch only window metadata against the scan-resident
    code table; the score kernels gather each window's codes themselves.
    `dispatch` routes as the reference does (scheduler.py:547-558): the
    chain tier by default (B3), over-cap windows to the mixed-profile gang
    (B5) or, under DECIPHON_CHAIN_SEG=1, to carry segments (B8), and the
    rest to the plain rung buckets (B1), which DECIPHON_NO_CHAIN=1 forces
    for everything.  An `hbm_table` scorer (the reference's name for its
    large-K tier, Kp > 5120) never chains: every window rides the rung
    buckets on B4.  Phase 2 runs the path kernel and the device walk,
    returning un-fetched step arrays.

    Its tables are held as _HostTables holds them; a streamed scorer's
    gang runs B4m, as the reference's streamed gang does."""

    # Merge length rungs below this into one bucket (short reads would
    # otherwise spray one near-empty launch per rung).
    NLB_FLOOR = 32
    # Chain tier on by default; admission cap in l-blocks (~20 knt): longer
    # windows ride the gang (or carry segments) so the pinned chain cap
    # stays near the common window size.
    CHAIN = True
    CHAIN_MAX_BLK = 512
    # xtrans LUT rows (distinct window lengths per scan); windows past it
    # ride the classic buckets.
    XT_LUT_CAP = 1024
    # Width cap of mixed-profile gang groups.
    GANG_W = 16
    # Large-K phase 2: one launch's trellis (windows * Lk * (Kp + 1)
    # int32) is held to this many bytes, one window at least (a 20-knt
    # window at Kp 16512 alone is 1.3 GB).  The reference caps its large-K
    # path batches at 256 MB of its compact trellis for a TPU's 16 GB; this
    # is the port's own bound, 10% of the card's 80 GB.
    PATH_BATCH_BYTES = 8 << 30

    def __init__(self, costs_list: list[ViterbiCosts],
                 device: torch.device | str, w: int = 8,
                 hbm_table: bool = False):
        self.w = w
        self.hbm_table = hbm_table
        self.Kp = common_kp(costs_list)
        vk._check_kp(self.Kp, vk.MAX_LARGE_KP if hbm_table else vk.MAX_KP)
        super().__init__(device, *stack_tables(costs_list, self.Kp))
        self._Ks = np.array([c.K for c in costs_list], np.int64)
        self.dev_codes: DeviceSeqCodes | None = None
        self.metrics = None  # optional ScanMetrics for phase walls
        self._chain_pin: tuple[int, int, int] | None = None
        self._xt_lut = np.zeros((self.XT_LUT_CAP, 16), np.float32)
        self._xt_lut_idx: dict = {}
        self._xt_lut_dev: torch.Tensor | None = None

    @property
    def codes_all(self) -> torch.Tensor:
        """The scan's code table on this scorer's device."""
        return self.dev_codes.on(self.device)

    def set_device_codes(self, dev_codes: DeviceSeqCodes | None) -> None:
        self.dev_codes = dev_codes
        self._chain_pin = None  # new scan: pin the chain shape again
        self._xt_lut_idx.clear()
        self._xt_lut_dev = None

    def _walls(self, t0: float, t1: float) -> None:
        if self.metrics is not None:
            self.metrics.add_wall("pack", t1 - t0)
            self.metrics.add_wall("dispatch", time.perf_counter() - t1)

    def _invoke_scores_from_starts(self, pidx, xts, lens, starts):
        """The classic phase-1 kernel call (device-resident codes): B1, or
        B4 for an `hbm_table` scorer."""
        pidx, xts, lens, starts = _tensors(self.device, pidx, xts, lens,
                                           starts)
        fn = vk.scores_pairs_large if self.hbm_table else vk.scores_pairs
        return fn(pidx, self.tables, self.tvecs, xts, lens, starts,
                  self.codes_all)

    def dispatch(self, items: list[PairItem]) -> list:
        """Enqueue every launch of one wave without blocking.  The chain
        tier is the production path; the classic rung buckets take the
        chain overflow, and DECIPHON_NO_CHAIN=1 forces them for every
        window (ablations).  An `hbm_table` scorer never chains
        (scheduler.py:554)."""
        if (self.CHAIN and not self.hbm_table and items
                and os.environ.get("DECIPHON_NO_CHAIN", "").lower()
                not in ("1", "true")):
            return self._dispatch_chained(items)
        return self._dispatch_classic(items)

    def _dispatch_classic(self, items: list[PairItem]) -> list:
        """Rung-bucketed dispatch (one window per slot).  The reference's
        in-flight byte cap bounded gathered code blocks; the fused gather
        materializes none, so there is no cap here."""
        inflight = []
        for bucket in build_batches(items, vk.KAPPA, w=self.w,
                                    nlb_floor=self.NLB_FLOOR):
            t0 = time.perf_counter()
            pidx, xts, lens, starts = bucket_arrays_meta(bucket,
                                                         self.dev_codes)
            t1 = time.perf_counter()
            alt, nul = self._invoke_scores_from_starts(pidx, xts, lens,
                                                       starts)
            self._walls(t0, t1)
            if self.metrics is not None and _sync_debug():
                name = (f"bkt_kp{self.Kp}_nlb{bucket.nlb}_n{len(pidx)}"
                        f"_w{bucket.w}" + ("_hbm" if self.hbm_table else ""))
                true = int((lens.reshape(len(pidx), -1).sum(axis=1)
                            .astype(np.int64) * 5 * self._Ks[pidx]).sum())
                _bucket_ledger(self.metrics, alt, name, true,
                               len(pidx) * bucket.w * bucket.nlb * vk.KAPPA
                               * 5 * self.Kp)
            inflight.append((bucket, alt, nul))
        return inflight

    # -- chained multi-window slots (production phase-1 path) ----------

    def _xt_index(self, it: PairItem) -> int | None:
        """Row of the per-scan xtrans LUT for this window (None = LUT
        full; the item falls back to the classic path)."""
        key = (it.multi_hits, it.hmmer3_compat, it.win.length)
        idx = self._xt_lut_idx.get(key)
        if idx is None:
            if len(self._xt_lut_idx) >= self.XT_LUT_CAP:
                return None
            idx = len(self._xt_lut_idx)
            self._xt_lut_idx[key] = idx
            self._xt_lut[idx, :13] = it.xt
            self._xt_lut_dev = None  # upload again on the next dispatch
        return idx

    def _dispatch_chained(self, items: list[PairItem]) -> list:
        """The reference's `_dispatch_chained` (scheduler.py:600-880),
        branch for branch."""
        kappa = vk.KAPPA
        cw = vk.CW

        def blk(it):
            return -(-it.win.length // kappa)

        if self._chain_pin is None:
            # Pin (cap, cmax, w) for the scan from the first wave: cap is
            # the rung covering 90% of the chainable block mass; longer
            # windows ride the classic buckets or the gang.
            chainable = [it for it in items
                         if blk(it) <= self.CHAIN_MAX_BLK]
            if not chainable:
                return self._dispatch_classic(items)
            blks = np.sort(np.array([blk(it) for it in chainable]))
            cap = quantize_nlb(max(_mass_p90(blks), self.NLB_FLOOR))
            admitted: dict[int, list[PairItem]] = {}
            for it in chainable:
                if blk(it) <= cap:
                    admitted.setdefault(it.p_idx, []).append(it)
            bmax = max(sum(blk(it) for it in g)
                       for g in admitted.values())
            nslots = -(-bmax // cap)
            w_c = max(8, min(self.w, next_pow2(max(nslots, 1))))
            cmax = 0
            for g in admitted.values():
                wins = sorted(((it, blk(it)) for it in g),
                              key=lambda x: (-x[1], x[0].s_idx,
                                             x[0].win.idx))
                for slot, _load in _lpt_pack(wins, w_c, cap,
                                                        float("inf")):
                    cmax = max(cmax, len(slot))
            # deeper chains split into extra slots at dispatch
            cmax = min(next_pow2(max(cmax, 1)), 4)
            self._chain_pin = (cap, max(cmax, 1), w_c)
        cap, cmax, w_c = self._chain_pin

        # Over cap: windows up to CHAIN_MAX_BLK (outliers of the p90 pin)
        # ride the classic buckets; longer ones (long-read windowing)
        # ride the mixed-profile gang, or carry segments threaded through
        # consecutive chain chunks under DECIPHON_CHAIN_SEG=1.
        use_seg = os.environ.get("DECIPHON_CHAIN_SEG", "").lower() \
            in ("1", "true")
        fallback: list[PairItem] = []
        per: dict[int, list[tuple[PairItem, int]]] = {}
        seg_wins: dict[int, list[PairItem]] = {}
        gang_items: list[PairItem] = []
        for it in items:
            b = blk(it)
            if self._xt_index(it) is None:
                fallback.append(it)
            elif b > cap:
                if b <= self.CHAIN_MAX_BLK:
                    fallback.append(it)
                elif use_seg:
                    seg_wins.setdefault(it.p_idx, []).append(it)
                else:
                    gang_items.append(it)
            else:
                per.setdefault(it.p_idx, []).append((it, b))

        # bound concurrent segment windows: CW carry slots per pair,
        # NCHUNK segment pairs per chunk; the rare excess rides classic
        seg_plan: dict[int, list[PairItem]] = {}
        for p_idx, wins in seg_wins.items():
            wins.sort(key=lambda it: (it.s_idx, it.win.idx))
            seg_plan[p_idx] = wins[:cw]
            fallback.extend(wins[cw:])
        for p_idx in sorted(seg_plan)[NCHUNK:]:
            fallback.extend(seg_plan.pop(p_idx))

        inflight = self._dispatch_classic(fallback) if fallback else []
        if gang_items:
            inflight.extend(self._dispatch_gang(gang_items))
        if not per and not seg_plan:
            return inflight
        if self._xt_lut_dev is None:
            self._xt_lut_dev = torch.from_numpy(self._xt_lut).to(self.device)

        def nseg(it):
            return -(-blk(it) // cap)

        # pack each profile's normal windows into a slot queue; segment
        # chunks draw from it to fill their pairs' spare slots
        slotq: dict[int, list[list[PairItem]]] = {}
        for p_idx in sorted(per):
            wins = sorted(per[p_idx],
                          key=lambda x: (-x[1], x[0].s_idx, x[0].win.idx))
            slotq[p_idx] = [s for s, _ in
                            _lpt_pack(wins, w_c, cap, cmax)]

        # segment-chunk skeleton: chunk t carries segment t of every live
        # over-cap window (slot rank < CW), padded out with normal slots
        # of the same profile
        T = max((nseg(it) for wins in seg_plan.values() for it in wins),
                default=0)
        chunks: list[tuple[list, list | None, int]] = []
        prev_pos: dict[int, tuple[int, int]] = {}
        for t in range(T):
            chunk_pairs = []
            pos: dict[int, tuple[int, int]] = {}
            conts: list[tuple[int, int, int]] = []  # (gi, wi, src flat)
            for p_idx in sorted(seg_plan):
                alive = [it for it in seg_plan[p_idx] if nseg(it) > t]
                if not alive:
                    continue
                gi = len(chunk_pairs)
                slots: list = []
                for rank, it in enumerate(alive):
                    slots.append(("seg", it, t))
                    pos[id(it)] = (gi, rank)
                    if t > 0:
                        sgi, swi = prev_pos[id(it)]
                        conts.append((gi, rank, sgi * cw + swi))
                q = slotq.get(p_idx, [])
                while len(slots) < w_c and q:
                    slots.append(("norm", q.pop(0), None))
                chunk_pairs.append((p_idx, slots))
            chunks.append((chunk_pairs, conts, w_c))
            prev_pos = pos

        # leftover normal slots -> plain chain chunks ({64, 8, 1} pairs).
        # Pairs whose slots fit the narrow width w_n ride it, so a tail
        # wave's few chains per profile do not pad out to w_c.  Each
        # distinct width is dispatched once (the reference loops over
        # (w_c, w_n) and launches every leftover chunk twice when
        # w_c == 8).  Its 8-group split of NCHUNK chunks bounded the
        # gathered code blocks in flight; the fused gather materializes
        # none, so chunks stay at NCHUNK.
        w_n = max(8, w_c // 4)
        by_width: dict[int, list[tuple[int, list]]] = {w_c: [], w_n: []}
        for p_idx in sorted(slotq):
            slots = slotq[p_idx]
            for i in range(0, len(slots), w_c):
                part = [("norm", s, None) for s in slots[i:i + w_c]]
                wb = w_n if len(part) <= w_n else w_c
                by_width[wb].append((p_idx, part))
        for wb, pairs in by_width.items():
            i0 = 0
            for size in chunk_sizes(len(pairs)):
                chunks.append((pairs[i0:i0 + size], None, wb))
                i0 += size

        # Every chunk stays in flight until the wave's one collect: the
        # reference drained early chunks past INFLIGHT_BYTES of gathered
        # code blocks, which the fused gather never materializes.
        carry_prev = None  # (cbig, csml) of the previous segment chunk
        for ci_chunk, (chunk, conts, w_ck) in enumerate(chunks):
            is_seg = ci_chunk < T
            t0 = time.perf_counter()
            N = pad_groups(len(chunk))
            pidx = np.zeros((N,), np.int32)
            sblk = np.zeros((N, w_ck, cmax), np.int32)
            wlen = np.zeros((N, w_ck, cmax), np.int32)
            gst = np.full((N, w_ck, cmax), self.dev_codes.pad_start,
                          np.int32)
            xti = np.zeros((N, w_ck, cmax), np.int32)
            groups = []
            for gi, (p_idx, slots) in enumerate(chunk):
                pidx[gi] = p_idx
                gslots = []
                for wi, (kind, payload, t) in enumerate(slots):
                    if kind == "seg":
                        it = payload
                        ns = nseg(it)
                        if t < ns - 1:  # intermediate: cap whole blocks
                            wlen[gi, wi, 0] = cap * kappa
                            gslots.append([])
                        else:  # final segment: latches the window
                            wlen[gi, wi, 0] = (it.win.length
                                               - (ns - 1) * cap * kappa)
                            gslots.append([it])
                        gst[gi, wi, 0] = it.gstart + t * cap * kappa
                        xti[gi, wi, 0] = self._xt_index(it)
                    else:
                        b = 0
                        for ci, it in enumerate(payload):
                            sblk[gi, wi, ci] = b
                            wlen[gi, wi, ci] = it.win.length
                            gst[gi, wi, ci] = it.gstart
                            xti[gi, wi, ci] = self._xt_index(it)
                            b += blk(it)
                        gslots.append(payload)
                groups.append(gslots)
            meta = (pidx, sblk, wlen, gst, xti)
            if is_seg:
                conts_arr = np.zeros((N, w_ck), np.int32)
                route = np.zeros((N * cw,), np.int32)
                for gi, wi, src in conts:
                    conts_arr[gi, wi] = 1
                    route[gi * cw + wi] = src
            t1 = time.perf_counter()
            if is_seg:
                alt, nul, cbig, csml = self._invoke_scores_chained_carry(
                    *meta, conts_arr, route, carry_prev)
                carry_prev = (cbig, csml)
            else:
                alt, nul = self._invoke_scores_chained(*meta)
            self._walls(t0, t1)
            if self.metrics is not None and _sync_debug():
                self._chain_ledger(alt, is_seg, cap, len(chunk), pidx, wlen)
            inflight.append((_ChainChunk(groups), alt, nul))
        return inflight

    def _chain_ledger(self, alt, is_seg: bool, cap: int, ngroups: int,
                      pidx, wlen) -> None:
        """The bucket ledger of one chain (B3) or carry (B8) launch, and
        under DECIPHON_FILL_DEBUG its FILL line (groups used of N, slots
        holding a window, l-blocks of windows against the launch's, and the
        fullest slot's blocks)."""
        N, w, _ = wlen.shape
        name = (f"bkt_chain{'seg' if is_seg else ''}_kp{self.Kp}"
                f"_cap{cap}_n{N}_w{w}")
        true = int((wlen.sum(axis=(1, 2)).astype(np.int64) * 5
                    * self._Ks[pidx]).sum())
        _bucket_ledger(self.metrics, alt, name, true,
                       N * w * cap * vk.KAPPA * 5 * self.Kp)
        if os.environ.get("DECIPHON_FILL_DEBUG"):
            blocks = -(-wlen // vk.KAPPA)
            slot_blocks = blocks.sum(axis=2)
            print(f"FILL {name}: groups={ngroups}/{N} "
                  f"slots_used={int((slot_blocks > 0).sum())}/{N * w} "
                  f"blocks={int(blocks.sum())}/{N * w * cap} "
                  f"maxslot={int(slot_blocks.max())}", flush=True)

    def _invoke_scores_chained(self, pidx, sblk, wlen, gst, xti):
        """The chained phase-1 kernel call (B3)."""
        pidx, sblk, wlen, gst, xti = _tensors(self.device, pidx, sblk, wlen,
                                              gst, xti)
        return vk.scores_pairs_chained(pidx, self.tables, self.tvecs, sblk,
                                       wlen, gst, xti, self._xt_lut_dev,
                                       self.codes_all)

    def _invoke_scores_chained_carry(self, pidx, sblk, wlen, gst, xti,
                                     conts, route, carry_prev):
        """Carry-mode chained call (B8): routes the previous segment
        chunk's exported state into this chunk's carry_in on the device,
        then launches."""
        N = pidx.shape[0]
        pidx, sblk, wlen, gst, xti, conts = _tensors(
            self.device, pidx, sblk, wlen, gst, xti, conts)
        if carry_prev is None:
            cbig = torch.zeros((N, 13, vk.CW, self.Kp), device=self.device)
            csml = torch.zeros((N, 32, vk.CW, 1), device=self.device)
        else:
            cbig, csml = vk.carry_permute(*carry_prev,
                                          torch.from_numpy(route))
        return vk.scores_pairs_chained_carry(
            pidx, self.tables, self.tvecs, sblk, wlen, gst, xti, conts,
            cbig, csml, self._xt_lut_dev, self.codes_all)

    def _dispatch_gang(self, items: list[PairItem]) -> list:
        """Mixed-profile groups for over-cap windows (B5, or B4m for
        streamed tables: `_invoke_scores_gang`)."""
        # one length-sorted packing across all profiles: longest first
        # keeps same-scale windows together
        wins = sorted(items, key=lambda it: (-it.win.length, it.p_idx,
                                             it.s_idx, it.win.idx))
        wg = max(8, min(self.GANG_W, next_pow2(len(wins))))
        groups = [wins[i:i + wg] for i in range(0, len(wins), wg)]
        per_rung: dict[int, list] = {}
        for g in groups:
            nlb = max(self.NLB_FLOOR,
                      quantize_nlb(max(1, -(-g[0].win.length
                                            // vk.KAPPA))))
            per_rung.setdefault(nlb, []).append(g)
        entries: list = []
        for nlb in sorted(per_rung):
            rgroups = per_rung[nlb]
            i0 = 0
            for size in chunk_sizes(len(rgroups)):
                chunk = rgroups[i0:i0 + size]
                i0 += size
                t0 = time.perf_counter()
                N = pad_groups(size)
                pidx = np.zeros((N, wg), np.int32)
                xts = np.zeros((N, wg, 16), np.float32)
                lens = np.zeros((N, wg, 1), np.int32)
                starts = np.full((N, wg), self.dev_codes.pad_start,
                                 np.int32)
                for gi, g in enumerate(chunk):
                    for wi, it in enumerate(g):
                        pidx[gi, wi] = it.p_idx
                        xts[gi, wi, :13] = it.xt
                        lens[gi, wi, 0] = it.win.length
                        starts[gi, wi] = it.gstart
                t1 = time.perf_counter()
                alt, nul = self._invoke_scores_gang(pidx, xts, lens, starts)
                self._walls(t0, t1)
                if self.metrics is not None and _sync_debug():
                    name = (f"bkt_gang{'v' if self._gang_resident() else ''}"
                            f"_kp{self.Kp}_nlb{nlb}_n{N}_w{wg}")
                    true = int((lens[:, :, 0].astype(np.int64) * 5
                                * self._Ks[pidx]).sum())
                    _bucket_ledger(self.metrics, alt, name, true,
                                   N * wg * nlb * vk.KAPPA * 5 * self.Kp)
                entries.append((_Bucket(nlb=nlb, groups=chunk, w=wg),
                                alt, nul))
        return entries

    def _gang_resident(self) -> bool:
        """Which gang kernel runs: B5 (True) or B4m.  The reference runs
        its VMEM-table kernel while the stack fits MIXED_VMEM_TABLE_BUDGET
        (48 MB of a TPU's VMEM) and its tables neither stream nor are
        large-K, and the HBM-table kernel otherwise.  On the card no table
        is held on-chip, so that budget has no counterpart: a resident
        stack keeps B5 at any size, a streamed one takes B4m."""
        return not self.hbm_table and not self.stream_tables

    def _invoke_scores_gang(self, pidx, xts, lens, starts):
        """Mixed-profile scoring call (one profile per slot): B5, or B4m
        for streamed tables."""
        pidx, xts, lens, starts = _tensors(self.device, pidx, xts, lens,
                                           starts)
        fn = (vk.scores_pairs_mixed if self._gang_resident()
              else vk.scores_pairs_mixed_large)
        return fn(pidx, self.tables, self.tvecs, xts, lens, starts,
                  self.codes_all)

    @staticmethod
    def _collect_one(entry, results) -> None:
        bucket, alt, nul = entry
        alt = np.asarray(alt)
        nul = np.asarray(nul)
        if isinstance(bucket, _ChainChunk):
            for gi, g in enumerate(bucket.groups):
                for wi, slot in enumerate(g):
                    for ci, it in enumerate(slot):
                        results[id(it)] = (float(nul[gi, wi, ci]),
                                           float(alt[gi, wi, ci]))
            return
        for gi, g in enumerate(bucket.groups):
            for wi, it in enumerate(g):
                results[id(it)] = (float(nul[gi, wi]), float(alt[gi, wi]))

    def collect(self, inflight) -> dict[int, tuple[float, float]]:
        """Host copies of a dispatch's outputs -> {id(item): (null, alt)};
        entries may already hold numpy arrays (BucketedPairScorer fetches
        a whole wave at once)."""
        results: dict[int, tuple[float, float]] = {}
        for bucket, alt, nul in inflight:
            if not isinstance(alt, np.ndarray):
                t0 = time.perf_counter()
                alt, nul = fetch_planes([alt, nul])
                if self.metrics is not None:
                    self.metrics.add_wall("collect",
                                          time.perf_counter() - t0)
            self._collect_one((bucket, alt, nul), results)
        return results

    def score(self, items: list[PairItem]) -> dict[int, tuple[float, float]]:
        """Returns {id(item) -> (null_cost, alt_cost)}."""
        return self.collect(self.dispatch(items))

    # -- phase 2: path kernel + device traceback -----------------------

    def path_launches(self, items: list[PairItem]):
        """The path launches of these survivors, one at a time: yields
        (trellis bytes, launch), and launch() runs B2 and the walk and
        returns the entry, so a caller can make room before each launch.
        A streamed scorer places its tables once more for these launches
        (counted in UPLOADS["phase2"]) and drops them after the last."""
        if not items:
            return
        if self.stream_tables and self._tables_cache is None:
            UPLOADS["phase2"] += 1
        try:
            for bucket in self._path_buckets(items):
                n = (len(bucket.groups) if self.hbm_table
                     else pad_groups(len(bucket.groups)))
                yield (n * bucket.w * bucket.nlb * vk.PATH_KAPPA
                       * (self.Kp + 1) * 4,
                       lambda bucket=bucket: self._path_launch(bucket))
        finally:
            self.release_tables()

    def _path_launch(self, bucket: _Bucket) -> tuple:
        t0 = time.perf_counter()
        wb = bucket.w
        meta = bucket_arrays_meta(bucket, self.dev_codes)
        if self.hbm_table:  # no pad pairs: each one is Lk x Kp words
            meta = [a[:len(bucket.groups)] for a in meta]
        pidx, xts, lens, starts = _tensors(self.device, *meta)
        xn, nd = vk.paths_pairs(pidx, self.tables, self.tvecs, xts, lens,
                                starts, self.codes_all, nlb=bucket.nlb)
        # the walk reads the real (pair, slot) rows in place
        rows, flat_items, lengths = [], [], []
        for gi, g in enumerate(bucket.groups):
            for wi, it in enumerate(g):
                rows.append(gi * wb + wi)
                flat_items.append(it)
                lengths.append(it.win.length)
        Lk = bucket.nlb * vk.PATH_KAPPA
        NP = xn.shape[0]
        xnf = xn.reshape(NP * wb, Lk)
        ndf = nd.reshape(NP * wb, Lk, self.Kp)
        rows_t = torch.tensor(rows, dtype=torch.int32).to(self.device)
        lens_t = torch.tensor(lengths, dtype=torch.int32).to(self.device)
        max_steps = Lk + 4 * self.Kp + 64
        sts, szs, ns, oks = walk(xnf, ndf, rows_t, lens_t, max_steps)
        if self.metrics is not None:
            self.metrics.add_wall("phase2_path", time.perf_counter() - t0)
        return (flat_items, sts, szs, ns, oks, xnf, ndf, rows, lengths)

    def _path_buckets(self, items: list[PairItem]) -> list[_Bucket]:
        """Path launches of these survivors: `build_batches`' rung buckets
        of 8-slot groups, or for an `hbm_table` scorer one window per pair
        (W = 1, whatever its profile), as many windows of one rung per
        launch as keep its trellis (Lk positions of Kp + 1 words each)
        within PATH_BATCH_BYTES, one at least: a large-K survivor's
        trellis is too large to pad, and its windows run side by side."""
        if not self.hbm_table:
            return build_batches(items, vk.PATH_KAPPA, w=8)
        per: dict[int, list[PairItem]] = {}
        for it in items:
            nlb = quantize_nlb(max(1, -(-it.win.length // vk.PATH_KAPPA)))
            per.setdefault(nlb, []).append(it)
        out = []
        for nlb, wins in sorted(per.items()):
            window_bytes = nlb * vk.PATH_KAPPA * (self.Kp + 1) * 4
            n = max(1, self.PATH_BATCH_BYTES // window_bytes)
            for i in range(0, len(wins), n):
                out.append(_Bucket(nlb=nlb, groups=[[it] for it in
                                                    wins[i:i + n]], w=1))
        return out


class PackedPairScorer(_HostTables):
    """Lane-packed scorer for one seg-need class of small-K profiles.

    Profiles pack NSEG side by side on the lanes of one plane (pack i =
    profiles [i * nseg, (i + 1) * nseg) of the K-sorted class), so a slot
    scores its window against a whole pack at once.  Every segment of a
    slot scans the SAME window, so phase-1 items split by a static rule:
    whole-read windows (win == [0, seq.size), identical across profiles
    whenever they exist) and the windows of uniform-K packs go to the
    packed kernels (B7 chained, or B6 under DECIPHON_NO_CHAIN=1);
    everything else (multi-window long reads, and all of phase 2)
    delegates to an inner unpacked PairScorer over the same profiles,
    whose tables are held beside the packed ones.

    Contract-compatible with PairScorer: dispatch()/collect()/score()/
    path_launches()/set_device_codes(); its entries interleave
    freely with the inner scorer's in one wave handle.

    Its tables, packed and inner, are held as _HostTables holds them:
    `table_bytes`, `set_streaming` and `release_tables` act on both.

    PACKED_W and the chain pin's cmax of 4 are inherited from the
    reference, where they were tuned for another accelerator; they are not
    derived on this hardware."""

    NLB_FLOOR = PairScorer.NLB_FLOOR
    XT_LUT_CAP = PairScorer.XT_LUT_CAP
    CHAIN_MAX_BLK = PairScorer.CHAIN_MAX_BLK
    # group width per packed plane width Kp (64 elsewhere)
    PACKED_W = {128: 128, 256: 128, 384: 64, 512: 128}

    def __init__(self, costs_list: list[ViterbiCosts], nseg: int,
                 device: torch.device | str, inner_w: int | None = None,
                 seg: int | None = None, inner_factory=None):
        self.nseg = nseg
        self.seg = seg if seg is not None else max(
            round_up(c.K + 2, 64) for c in costs_list)
        self.Kp = self.seg * nseg
        if self.Kp % 128:
            raise ValueError(f"seg {self.seg} x nseg {nseg} is not a "
                             "multiple of 128 lanes")
        npack = -(-len(costs_list) // nseg)
        # true K summed over each pack's profiles (the bucket ledgers'
        # true cells)
        self._pack_ksum = np.array(
            [sum(c.K for c in costs_list[i * nseg:(i + 1) * nseg])
             for i in range(npack)], np.int64)
        # uniform-K packs share WINDOW boundaries (windowing is a function
        # of K alone), so their windowed reads pack too; otherwise only
        # whole-read windows are shared by a pack
        self._uniform_pack = [
            len({c.K for c in costs_list[i * nseg:(i + 1) * nseg]}) == 1
            for i in range(npack)]
        super().__init__(device, *stack_tables_packed(costs_list, self.seg,
                                                      nseg))
        self.w = self.PACKED_W.get(self.Kp, 64)
        # `inner_factory(costs, device, w=)` builds the inner scorer (the
        # multi-device tier passes its own, scheduler.py:1286 of the
        # reference)
        make_inner = inner_factory or PairScorer
        self.inner = make_inner(costs_list, self.device,
                                w=inner_w if inner_w is not None else W)
        self.dev_codes: DeviceSeqCodes | None = None
        self._metrics = None
        self._w_pinned: int | None = None
        # chained packed planes: the same xtrans LUT and (cap, cmax, w,
        # maxblk) pin machinery as PairScorer
        self._xt_lut = np.zeros((self.XT_LUT_CAP, 16), np.float32)
        self._xt_lut_idx: dict = {}
        self._xt_lut_dev: torch.Tensor | None = None
        self._chain_pin: tuple[int, int, int, int] | None = None

    def table_bytes(self) -> int:
        """Bytes of the packed tables and the inner scorer's (host
        tensors)."""
        return super().table_bytes() + self.inner.table_bytes()

    def set_streaming(self, on: bool) -> None:
        super().set_streaming(on)
        self.inner.set_streaming(on)

    def release_tables(self) -> None:
        """Drop the packed tables and the inner scorer's (the reference
        releases only the packed ones, so its streamed inner tables stay
        on the device once placed)."""
        super().release_tables()
        self.inner.release_tables()

    # metrics propagate to the inner scorer so wall buckets stay unified
    @property
    def metrics(self):
        return self._metrics

    @metrics.setter
    def metrics(self, m) -> None:
        self._metrics = m
        self.inner.metrics = m

    _xt_index = PairScorer._xt_index
    _walls = PairScorer._walls
    codes_all = PairScorer.codes_all

    def set_device_codes(self, dev_codes: DeviceSeqCodes | None) -> None:
        self.dev_codes = dev_codes
        self._w_pinned = None
        self._xt_lut_idx.clear()
        self._xt_lut_dev = None
        self._chain_pin = None
        self.inner.set_device_codes(dev_codes)

    def dispatch(self, items: list[PairItem]) -> list:
        """Enqueue every launch of one wave without blocking: shareable
        windows on the packed planes, chained (B7) unless
        DECIPHON_NO_CHAIN=1 (then B6, as that switch sends unpacked
        windows to B1; the reference's packed tier does not read it), the
        rest through the inner scorer."""
        use_dev = self.dev_codes is not None
        packed: list[PairItem] = []
        rest: list[PairItem] = []
        for it in items:
            # an item without its read (seq=None) cannot be known whole
            whole = (it.seq is not None and it.win.start == 0
                     and it.win.stop == it.seq.size)
            if use_dev and (whole
                            or self._uniform_pack[it.p_idx // self.nseg]):
                packed.append(it)
            else:
                rest.append(it)
        chain = (PairScorer.CHAIN
                 and os.environ.get("DECIPHON_NO_CHAIN", "").lower()
                 not in ("1", "true"))
        if packed and chain:
            packed, chained = self._dispatch_packed_chained(packed)
            rest = rest + packed
            inflight = list(self.inner.dispatch(rest)) if rest else []
            return inflight + chained
        inflight = list(self.inner.dispatch(rest)) if rest else []
        if packed:
            inflight.extend(self._dispatch_packed(packed))
        return inflight

    def _dispatch_packed_chained(self, items: list[PairItem]):
        """Chain shareable windows into lane-packed planes (the
        reference's `_dispatch_packed_chained`, branch for branch).

        Rows (one per (pack, window identity)) chain back to back into
        the W slots of each pack's groups with per-slot reseeds, exactly
        like PairScorer._dispatch_chained, but every row is scored
        against the pack's NSEG profiles at once.  Returns
        (leftover_items, entries): rows past the cap pin or the LUT fall
        back to the caller's inner dispatch."""
        kappa = vk.KAPPA

        # rows: pack -> {window identity -> [(segment, item), ...]}
        per: dict[int, dict] = {}
        for it in items:
            pack, s = divmod(it.p_idx, self.nseg)
            per.setdefault(pack, {}).setdefault(
                (it.s_idx, it.win.start, it.win.stop), []).append((s, it))

        def blk(length):
            return -(-length // kappa)

        if self._chain_pin is None:
            blks = np.sort(np.array(
                [blk(k[2] - k[1]) for rows in per.values() for k in rows]))
            if len(blks) == 0:
                return items, []
            cap = quantize_nlb(max(_mass_p90(blks), self.NLB_FLOOR))
            bmax = max(sum(blk(k[2] - k[1]) for k in rows
                           if blk(k[2] - k[1]) <= cap)
                       for rows in per.values())
            nslots = -(-bmax // cap)
            w_c = max(8, min(self.w, next_pow2(max(nslots, 1))))
            self._chain_pin = (cap, 4, w_c, cap)
        cap, cmax, w_c, maxblk = self._chain_pin

        leftover: list[PairItem] = []
        pairs: list[tuple[int, list]] = []  # (pack, [slot rows])
        for pack in sorted(per):
            rows = []
            for key in sorted(per[pack]):
                segs = per[pack][key]
                it0 = segs[0][1]
                b = blk(it0.win.length)
                xti = self._xt_index(it0)
                if b > maxblk or xti is None:
                    leftover.extend(it for _, it in segs)
                else:
                    rows.append(((key, segs, xti), b))
            rows.sort(key=lambda x: (-x[1], x[0][0]))
            slots = [s for s, _ in _lpt_pack(rows, w_c, cap, cmax)]
            for i in range(0, len(slots), w_c):
                pairs.append((pack, slots[i:i + w_c]))

        if not pairs:
            return leftover, []
        if self._xt_lut_dev is None:
            self._xt_lut_dev = torch.from_numpy(self._xt_lut).to(self.device)

        # narrow width for tail chunks: sparse pack groups ride a w/4
        # launch.  Each distinct width is dispatched once (the reference
        # loops over (w_c, w_n) and launches every chunk twice when
        # w_c == 8); its 8-group split of NCHUNK chunks bounded gathered
        # code blocks, which the fused gather never materializes.
        w_n = max(8, w_c // 4)
        by_width: dict[int, list] = {w_c: [], w_n: []}
        for pack, slots in pairs:
            wb = w_n if (w_n < w_c and len(slots) <= w_n) else w_c
            by_width[wb].append((pack, slots))
        chunks: list[tuple[list, int]] = []
        for wb, wpairs in by_width.items():
            i0 = 0
            for size in chunk_sizes(len(wpairs)):
                chunks.append((wpairs[i0:i0 + size], wb))
                i0 += size
        entries: list = []
        for chunk, w_ck in chunks:
            t0 = time.perf_counter()
            N = pad_groups(len(chunk))
            pidx = np.zeros((N,), np.int32)
            sblk = np.zeros((N, w_ck, cmax), np.int32)
            wlen = np.zeros((N, w_ck, cmax), np.int32)
            gst = np.full((N, w_ck, cmax), self.dev_codes.pad_start,
                          np.int32)
            xti = np.zeros((N, w_ck, cmax), np.int32)
            groups = []
            for gi, (pack, slots) in enumerate(chunk):
                pidx[gi] = pack
                gslots = []
                for wi, slot in enumerate(slots):
                    b = 0
                    grow = []
                    for ci, (_key, segs, xtin) in enumerate(slot):
                        it0 = segs[0][1]
                        sblk[gi, wi, ci] = b
                        wlen[gi, wi, ci] = it0.win.length
                        gst[gi, wi, ci] = it0.gstart
                        xti[gi, wi, ci] = xtin
                        b += blk(it0.win.length)
                        grow.append(segs)
                    gslots.append(grow)
                groups.append(gslots)
            t1 = time.perf_counter()
            alt, nul = self._invoke_scores_packed_chained(pidx, sblk, wlen,
                                                          gst, xti)
            self._walls(t0, t1)
            if self._metrics is not None and _sync_debug():
                name = (f"bkt_pchain_kp{self.Kp}_s{self.nseg}"
                        f"_cap{cap}_n{N}_w{w_ck}")
                true = int((wlen.sum(axis=(1, 2)).astype(np.int64) * 5
                            * self._pack_ksum[pidx]).sum())
                _bucket_ledger(self._metrics, alt, name, true,
                               N * w_ck * cap * kappa * 5 * self.Kp)
            entries.append((_PackedChainChunk(groups), alt, nul))
        return leftover, entries

    def _invoke_scores_packed_chained(self, pidx, sblk, wlen, gst, xti):
        """The packed chained phase-1 kernel call (B7).  Shareable
        windows are shared across a pack's segments, so the slot's code
        run chain IS the window chain, and every segment lists it (the
        kernel takes per-segment lists; the scheduler only emits the
        shared case).  The lists are laid out per segment on the
        device."""
        pidx, sblk, wlen, gst, xti = _tensors(self.device, pidx, sblk, wlen,
                                              gst, xti)
        N, Wc, C = sblk.shape

        def per_seg(a):
            return a[:, :, None, :].expand(N, Wc, self.nseg, C).contiguous()

        return vk.scores_pairs_packed_chained(
            pidx, self.tables, self.tvecs, sblk, wlen, gst, per_seg(sblk),
            per_seg(wlen), per_seg(xti), self._xt_lut_dev,
            self.codes_all, nseg=self.nseg)

    def _w_eff(self, rows_per_pack: int) -> int:
        if self._w_pinned is None:
            self._w_pinned = max(8, min(self.w,
                                        next_pow2(max(1, rows_per_pack))))
        return self._w_pinned

    def _dispatch_packed(self, items: list[PairItem]) -> list:
        """Rung-bucketed packed dispatch (B6, one window per slot).  As in
        `_dispatch_classic`, there is no in-flight byte cap."""
        # rows: (nlb rung, pack) -> {window identity -> [(segment, item)]}
        per: dict[tuple[int, int], dict] = {}
        for it in items:
            pack, s = divmod(it.p_idx, self.nseg)
            nlb = max(self.NLB_FLOOR,
                      quantize_nlb(max(1, -(-it.win.length // vk.KAPPA))))
            per.setdefault((nlb, pack), {}).setdefault(
                (it.s_idx, it.win.start, it.win.stop), []).append((s, it))

        w = self._w_eff(max(len(d) for d in per.values()))
        inflight: list = []
        for (nlb, pack) in sorted(per):
            rows = [per[(nlb, pack)][k] for k in sorted(per[(nlb, pack)])]
            groups = [rows[i:i + w] for i in range(0, len(rows), w)]
            i0 = 0
            for size in chunk_sizes(len(groups)):
                chunk = groups[i0:i0 + size]
                i0 += size
                t0 = time.perf_counter()
                N = pad_groups(len(chunk))
                pidx = np.full((N,), pack, np.int32)
                xts = np.zeros((N, w, 16), np.float32)
                lens = np.zeros((N, w, 1), np.int32)
                starts = np.full((N, w), self.dev_codes.pad_start, np.int32)
                for gi, g in enumerate(chunk):
                    for wi, slot in enumerate(g):
                        it0 = slot[0][1]  # window shared across segments
                        xts[gi, wi, :13] = it0.xt
                        lens[gi, wi, 0] = it0.win.length
                        starts[gi, wi] = it0.gstart
                t1 = time.perf_counter()
                alt, nul = self._invoke_scores_packed(pidx, xts, lens,
                                                      starts)
                self._walls(t0, t1)
                if self._metrics is not None and _sync_debug():
                    name = (f"bkt_packed_kp{self.Kp}_s{self.nseg}"
                            f"_nlb{nlb}_n{N}_w{w}")
                    true = int((lens[:, :, 0].astype(np.int64) * 5
                                * self._pack_ksum[pidx][:, None]).sum())
                    _bucket_ledger(self._metrics, alt, name, true,
                                   N * w * nlb * vk.KAPPA * 5 * self.Kp)
                inflight.append((chunk, alt, nul))
        return inflight

    def _invoke_scores_packed(self, pidx, xts, lens, starts):
        """The packed phase-1 kernel call (B6)."""
        pidx, xts, lens, starts = _tensors(self.device, pidx, xts, lens,
                                           starts)
        return vk.scores_pairs_packed(pidx, self.tables, self.tvecs, xts,
                                      lens, starts, self.codes_all,
                                      nseg=self.nseg)

    @staticmethod
    def _collect_entry(entry, results) -> None:
        head, alt, nul = entry
        if isinstance(head, (_Bucket, _ChainChunk)):  # inner entry
            PairScorer._collect_one(entry, results)
            return
        alt = np.asarray(alt)
        nul = np.asarray(nul)
        if isinstance(head, _PackedChainChunk):  # (N, W, S, C)
            for gi, g in enumerate(head.groups):
                for wi, slot in enumerate(g):
                    for ci, segs in enumerate(slot):
                        for s, it in segs:
                            results[id(it)] = (float(nul[gi, wi, s, ci]),
                                               float(alt[gi, wi, s, ci]))
            return
        for gi, g in enumerate(head):  # a B6 chunk, (N, W, S)
            for wi, slot in enumerate(g):
                for s, it in slot:
                    results[id(it)] = (float(nul[gi, wi, s]),
                                       float(alt[gi, wi, s]))

    def collect(self, inflight) -> dict[int, tuple[float, float]]:
        """Host copies of a dispatch's outputs -> {id(item): (null, alt)};
        entries may already hold numpy arrays."""
        results: dict[int, tuple[float, float]] = {}
        for head, alt, nul in inflight:
            if not isinstance(alt, np.ndarray):
                t0 = time.perf_counter()
                alt, nul = fetch_planes([alt, nul])
                if self._metrics is not None:
                    self._metrics.add_wall("collect",
                                           time.perf_counter() - t0)
            self._collect_entry((head, alt, nul), results)
        return results

    def score(self, items: list[PairItem]) -> dict[int, tuple[float, float]]:
        return self.collect(self.dispatch(items))

    def path_launches(self, items: list[PairItem]):
        return self.inner.path_launches(items)


def _device_memory(device: torch.device | str) -> int:
    """Total memory of the device, 16 GB assumed for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return 16 << 30


def device_reserve(device: torch.device | str) -> int:
    """The device's working reserve (codes, trellis, in-flight outputs):
    a quarter of its memory, 2 GB at least."""
    return max(int(_device_memory(device) * 0.25), 2 << 30)


def device_table_budget(device: torch.device | str) -> int:
    """Device bytes available for resident profile tables.

    DECIPHON_HBM_BUDGET overrides (bytes); otherwise the device's total
    memory minus its working reserve."""
    env = os.environ.get("DECIPHON_HBM_BUDGET")
    if env:
        return int(env)
    return max(_device_memory(device) - device_reserve(device), 1 << 30)


class HBMLedger:
    """Capacity ledger for per-bucket table residency (the
    DB-exceeds-HBM plan).

    The reference's design point is a 32 x 4 GB database streamed from
    disk through per-partition iterators (c-core/database_writer.c:14,
    protein_reader.c:77-101); a realistic Pfam press overflows one
    accelerator's HBM even before scratch.  The ledger assigns buckets
    to RESIDENT device tables until the budget runs out; the remainder
    STREAM host->device per wave (PairScorer.stream_tables), trading
    upload bandwidth for unbounded database size instead of OOMing.
    Biggest buckets stream first — their per-byte upload amortizes over
    the most compute.
    """

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self.resident: list[tuple[int, int]] = []  # (scorer idx, bytes)
        self.streamed: list[tuple[int, int]] = []

    def plan(self, sizes: list[int]) -> list[bool]:
        """sizes[i] = table bytes of scorer i; returns stream flags.
        Deterministic: larger tables considered first, so small buckets
        (the common-case hot mass) stay resident."""
        order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
        left = self.budget
        stream = [False] * len(sizes)
        for i in order:
            if sizes[i] <= left:
                left -= sizes[i]
                self.resident.append((i, sizes[i]))
            else:
                stream[i] = True
                self.streamed.append((i, sizes[i]))
        return stream

    @property
    def resident_bytes(self) -> int:
        return sum(b for _, b in self.resident)

    @property
    def streamed_bytes(self) -> int:
        return sum(b for _, b in self.streamed)


class BucketedPairScorer:
    """Partitions profiles into packed classes, plain Kp buckets and
    large-K buckets, one scorer each.

    Small-K profiles class by their 64-lane seg need and pack NSEG per
    plane (PackedPairScorer); a custom `scorer_factory` keeps everything
    in the plain buckets, which are powers of two over Kp up to 2048, then
    multiples of 512 (the reference's rules, scheduler.py
    BucketedPairScorer, branch for branch).  A bucket past MAX_KP lanes
    gets an `hbm_table` scorer (B4), whatever the factory, with the
    reference's `hbm_factory` slot width.  A capacity ledger (HBMLedger)
    keeps the largest tables that fit `hbm_budget` (device_table_budget
    by default) resident and streams the rest host->device per wave: those
    scorers drop their device tables after each dispatch.  Phase 2 holds
    at most `path_inflight_bytes` of trellis in flight (PATH_INFLIGHT_SHARE
    of the device's working reserve), collecting the oldest launches early
    past it.

    `devices` (more than one; a device may repeat) selects the
    device-parallel tier of parallel/multidevice.py, as the reference's
    `devices=` does (scheduler.py:1782-1800, 1886-1900): every plain,
    packed and large-K scorer is a MultiDevicePairScorer or
    MultiDevicePackedScorer over `make_mesh(devices)`, phase-1 waves split
    over the shards, tables replicated on every distinct device; phase 2
    and the large-K tier run on the first.  The ledger's budget is then
    the smallest device's, and `path_inflight_bytes` the first's.

    PACK_MAX_SEG, PACK_KP_MAX, W_LANE_BUDGET, w_cap, HBM_STATE_BUDGET and
    vk.HBM_STATE_BYTES_PER_LANE are inherited from the reference, where
    they were tuned for another accelerator; they are not derived on this
    hardware."""

    # Widest bucket of the plain tiers (the reference's MAX_PALLAS_KP);
    # wider buckets take the large-K tier.  A class attribute, so tests
    # can lower it.
    MAX_KP = vk.MAX_KP
    # The reference's largest profile (c-core/model.h:12).
    MAX_K = 16384
    # Slot-width rule of the reference (w * Kp state-plane budget).  On
    # the card each window is its own CTA, so w only sets how many
    # windows share one launch.
    W_LANE_BUDGET = 128 * 2048
    # The reference's large-K slot-width budget (VMEM bytes of w * Kp
    # lanes of DP state); on the card w only sets the windows per launch.
    HBM_STATE_BUDGET = 32_000_000
    # Lane packing: profiles whose 64-lane seg need is at most
    # PACK_MAX_SEG pack NSEG per plane, up to PACK_KP_MAX total lanes.
    # Classes form greedily from the largest seg need down, accepting
    # members within 2x (lane fill >= 0.5 before 64-lane quantization).
    PACK_MAX_SEG = 1024
    PACK_KP_MAX = vk.PACK_MAX_KP
    # Phase 2's trellis bytes in flight: this share of the working reserve
    # that device_table_budget leaves (20 GB of an 80 GB card), one launch
    # at least; the other half holds codes, phase-1 outputs and streamed
    # tables.  The port's own bound (the reference bounds its lax.scan
    # fallback's groups by its PATH_BATCH_BYTES, 256 MB).
    PATH_INFLIGHT_SHARE = 0.5

    @staticmethod
    def w_cap(kp: int) -> int:
        return 256 if kp <= 1024 else 128

    @classmethod
    def plain_w(cls, kp: int) -> int:
        """Slot width of a plain bucket of lane width kp."""
        return max(8, prev_pow2(min(cls.w_cap(kp), cls.W_LANE_BUDGET // kp)))

    @classmethod
    def hbm_w(cls, kp: int) -> int:
        """Slot width of a large-K bucket of lane width kp (the
        reference's `hbm_factory`): the largest power of two from 8 whose
        state fits HBM_STATE_BUDGET, at most 128."""
        wb = 8
        while wb * 2 <= min(128, cls.HBM_STATE_BUDGET //
                            (vk.HBM_STATE_BYTES_PER_LANE * kp)):
            wb *= 2
        return wb

    def __init__(self, costs_list: list[ViterbiCosts],
                 device: torch.device | str, scorer_factory=None,
                 hbm_budget: int | None = None, devices=None):
        self.device = torch.device(device)
        mesh = None
        if devices is not None and len(devices) > 1:
            from ..parallel.multidevice import (MultiDevicePackedScorer,
                                                MultiDevicePairScorer,
                                                make_mesh)

            mesh = make_mesh(devices)
            self.device = mesh[0]

        def make(costs, w, hbm_table=False):
            if mesh is not None:
                return MultiDevicePairScorer(costs, mesh=mesh, w=w,
                                             hbm_table=hbm_table)
            return PairScorer(costs, self.device, w=w, hbm_table=hbm_table)

        def default_factory(costs):
            return make(costs, self.plain_w(common_kp(costs)))

        factory = scorer_factory or default_factory

        # greedy class formation, largest seg need first: a class opened
        # at seg accepts members with segn >= seg / 2 (their lanes pad up
        # to seg); singleton classes stay unpacked (an nseg = 2 pack with
        # one pad segment is pure waste against the profile's own pow2
        # bucket).  Custom factories keep the plain pow2 buckets.
        plain: list[int] = []
        allow_packing = scorer_factory is None
        cand: list[tuple[int, int]] = []
        for i, c in enumerate(costs_list):
            segn = round_up(c.K + 2, 64)
            if allow_packing and segn <= self.PACK_MAX_SEG:
                cand.append((segn, i))
            else:
                plain.append(i)
        cand.sort(key=lambda x: (-x[0], x[1]))
        packed_classes: list[tuple[int, list[int]]] = []
        cur_seg: int | None = None
        cur: list[int] = []
        for segn, i in cand:
            if cur_seg is None or segn * 2 < cur_seg:
                if cur:
                    packed_classes.append((cur_seg, cur))
                cur_seg, cur = segn, [i]
            else:
                cur.append(i)
        if cur:
            packed_classes.append((cur_seg, cur))
        kept: list[tuple[int, list[int]]] = []
        for seg, idxs in packed_classes:
            if len(idxs) < 2:
                plain.extend(idxs)
            else:
                kept.append((seg, idxs))

        self._map: dict[int, tuple[int, int]] = {}
        self.scorers: list = []
        for segn, members in kept:
            idxs = sorted(members, key=lambda i: costs_list[i].K)
            # divisor-aware nseg: minimize total pack lanes
            # ceil(n / nseg) * nseg * seg (a 5-member class at nseg = 4
            # packs 4 + 1, and the singleton pack wastes 3 pad segments;
            # nseg = 3 packs 3 + 2 with one pad), tiebreak toward the
            # larger plane
            n = len(idxs)
            best = None
            for cand_nseg in range(2, min(8, max(
                    self.PACK_KP_MAX // segn, 2)) + 1):
                if (segn * cand_nseg) % 128:
                    continue
                units = -(-n // cand_nseg) * cand_nseg
                key = (units, -cand_nseg)
                if best is None or key < best[0]:
                    best = (key, cand_nseg)
            nseg = best[1] if best else 2
            while (segn * nseg) % 128:
                nseg *= 2  # seg = 192: S = 2 -> Kp = 384
            for local, gi in enumerate(idxs):
                self._map[gi] = (len(self.scorers), local)
            costs = [costs_list[i] for i in idxs]
            inner_kp = common_kp(costs)
            inner_w = max(8, min(self.w_cap(inner_kp),
                                 self.W_LANE_BUDGET // inner_kp))
            if mesh is not None:
                self.scorers.append(MultiDevicePackedScorer(
                    costs, nseg, mesh=mesh, inner_w=inner_w, seg=segn))
            else:
                self.scorers.append(PackedPairScorer(
                    costs, nseg, self.device, inner_w=inner_w, seg=segn))

        buckets: dict[int, list[int]] = {}
        for i in plain:
            c = costs_list[i]
            if c.K > self.MAX_K:
                raise NotImplementedError(
                    f"profile {i} has K={c.K}: the reference takes "
                    f"K <= {self.MAX_K}, and so do the port's kernels")
            kp = round_up(max(c.K + 2, 128), 128)
            b = next_pow2(kp)
            if b > 2048:
                b = round_up(kp, 512)
            buckets.setdefault(b, []).append(i)
        for b, idxs in sorted(buckets.items()):
            for local, gi in enumerate(idxs):
                self._map[gi] = (len(self.scorers), local)
            costs = [costs_list[i] for i in idxs]
            # oversized buckets take the large-K tier even under a custom
            # factory (the reference's scheduler.py:1921-1925)
            if b > self.MAX_KP:
                self.scorers.append(make(costs, self.hbm_w(common_kp(costs)),
                                         hbm_table=True))
            else:
                self.scorers.append(factory(costs))

        # capacity ledger: resident against streamed tables per scorer,
        # planned from the host tables before anything is placed; tables
        # are replicated over a mesh, so its smallest device bounds them
        self.ledger = HBMLedger(hbm_budget if hbm_budget is not None
                                else min(device_table_budget(d)
                                         for d in (mesh or [self.device])))
        plan = self.ledger.plan([s.table_bytes() for s in self.scorers])
        for scorer, stream in zip(self.scorers, plan):
            if stream:
                scorer.set_streaming(True)
        if self.ledger.streamed:
            get_logger("deciphon_tpu_torch.scan").warning(
                "profile tables exceed the device budget: %d/%d buckets "
                "(%.2f GB of %.2f GB) stream host->device per wave",
                len(self.ledger.streamed), len(self.scorers),
                self.ledger.streamed_bytes / 2**30,
                self.ledger.budget / 2**30)
        self.path_inflight_bytes = max(1, int(
            device_reserve(self.device) * self.PATH_INFLIGHT_SHARE))
        self.metrics = None

    def set_device_codes(self, dev_codes) -> None:
        for s in self.scorers:
            s.set_device_codes(dev_codes)

    def set_metrics(self, metrics) -> None:
        self.metrics = metrics
        for s in self.scorers:
            s.metrics = metrics

    def _split(self, items: list[PairItem]):
        """Group items by scorer, switching p_idx to local indices; the
        caller restores them with _restore."""
        by_scorer: dict[int, list[PairItem]] = {}
        remap: dict[int, int] = {}
        for it in items:
            si, local = self._map[it.p_idx]
            remap[id(it)] = it.p_idx
            it.p_idx = local
            by_scorer.setdefault(si, []).append(it)
        return by_scorer, remap

    @staticmethod
    def _restore(items, remap) -> None:
        for it in items:
            it.p_idx = remap[id(it)]

    def dispatch_all(self, items: list[PairItem]):
        """Enqueue every sub-scorer's launches for one wave without
        blocking; returns a handle for collect_all.  A streamed scorer
        drops its device tables right after its dispatch: the memory is
        freed once the enqueued launches have run."""
        by_scorer, remap = self._split(items)
        try:
            pending = []
            for si, group in by_scorer.items():
                scorer = self.scorers[si]
                pending.append((scorer, scorer.dispatch(group)))
                scorer.release_tables()
            return pending
        finally:
            self._restore(items, remap)

    def collect_all(self, pending) -> dict[int, tuple[float, float]]:
        """Fetch every scorer's outputs of one wave in ONE host transfer a
        device (all alt/null planes, (N, W), chained (N, W, C), packed
        (N, W, S) and packed chained (N, W, S, C), concatenated on their
        device, `fetch_planes`; carry planes never leave it)."""
        flat = [a for _, inflight in pending for e in inflight
                for a in (e[1], e[2])]
        t0 = time.perf_counter()
        host = iter(fetch_planes(flat))
        if self.metrics is not None:
            self.metrics.add_wall("collect", time.perf_counter() - t0)
        results: dict[int, tuple[float, float]] = {}
        for scorer, inflight in pending:
            results.update(scorer.collect(
                [(bucket, next(host), next(host))
                 for bucket, _, _ in inflight]))
        return results

    def score(self, items: list[PairItem]) -> dict[int, tuple[float, float]]:
        return self.collect_all(self.dispatch_all(items))

    def paths_dispatch(self, items: list[PairItem]) -> list:
        """Phase-2 trellis + walk dispatch through each sub-scorer's path
        kernel; returns un-fetched path entries.  Nothing is left over:
        B2 takes every tier's lane planes, the large-K tier's too (a
        cluster of CTAs a window past 2048 lanes), where the reference's
        path kernel stops at 5120 lanes and returns large-K survivors to
        the pipeline's lax.scan fallback (scheduler.py:2054-2058).  B2's
        trellis equals that fallback's bit for bit.

        The trellis bytes in flight stay within `path_inflight_bytes`
        (`dispatch_paths_bounded`: the oldest launches are collected
        early, and their results ride along as one dict among the
        entries)."""
        by_scorer, remap = self._split(items)
        try:
            return dispatch_paths_bounded(
                (launch for si, group in by_scorer.items()
                 for launch in self.scorers[si].path_launches(group)),
                self.path_inflight_bytes, self.metrics)
        finally:
            self._restore(items, remap)


def _pad_len(n: int) -> int:
    """Padded window length of a phase-2 group (few distinct shapes)."""
    if n <= 256:
        return round_up(max(n, 1), 64)
    return 1 << math.ceil(math.log2(n))


class TorchPairScorer:
    """The lax.scan engine's scorer, counterpart of the reference's
    JaxPairScorer (scheduler.py:2065-2099) with the reference pipeline's
    generic phase 2 (pipeline.py:483-546): plain PyTorch on `device`, no
    score or path kernel.  It keeps the kernel scorers' contract:
    `dispatch_all` scores a wave at once (ops/engine.py scan_scores, one
    call per window group) and `collect_all` hands the scores back;
    `paths_dispatch` runs viterbi_path_batch per (profile, padded length)
    group and the device walk on its trellis.  The per-profile cost
    tensors stay on `device` ("cuda" runs there or raises when no card is
    present)."""

    KAPPA = 32  # positions per length block of its buckets (the reference's)
    # Trellis bytes in flight in phase 2 (the reference pipeline's
    # constant): ~(2K+8) bytes per position per survivor, so groups are
    # chunked and older launches collected early to bound it.
    PATH_BATCH_BYTES = 256 << 20

    def __init__(self, costs_list: list[ViterbiCosts],
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TorchPairScorer(device={device!r}) but no "
                               "CUDA device is available")
        self.K = [c.K for c in costs_list]
        self._dev = [_tensors(self.device, c.core, c.match, c.null,
                              c.background) for c in costs_list]
        self.metrics = None

    def set_device_codes(self, dev_codes) -> None:
        """Nothing to hold: the engine reads each window's own codes."""

    def set_metrics(self, metrics) -> None:
        self.metrics = metrics

    def _wall(self, name: str, t0: float) -> None:
        if self.metrics is not None:
            self.metrics.add_wall(name, time.perf_counter() - t0)

    def dispatch_all(self, items: list[PairItem]):
        """Score one wave now (nothing is left in flight); the handle is
        {id(item) -> (null_cost, alt_cost)}."""
        t0 = time.perf_counter()
        scores = self.score(items)
        self._wall("dispatch", t0)
        return scores

    @staticmethod
    def collect_all(scores) -> dict[int, tuple[float, float]]:
        return scores

    def score(self, items: list[PairItem]) -> dict[int, tuple[float, float]]:
        """Returns {id(item) -> (null_cost, alt_cost)}."""
        results: dict[int, tuple[float, float]] = {}
        for bucket in build_batches(items, self.KAPPA):
            _, xts, lens, _, codes = bucket_arrays(bucket, self.KAPPA,
                                                   mode="raw")
            for gi, g in enumerate(bucket.groups):
                core, match, null, bg = self._dev[g[0].p_idx]
                xt_g, codes_g, lens_g = _tensors(
                    self.device, np.ascontiguousarray(xts[gi, :, :13]),
                    codes[gi], np.ascontiguousarray(lens[gi, :, 0]))
                nul, alt = scan_scores(core[None], match[None], null[None],
                                       bg[None], xt_g, codes_g, lens_g)
                nul = nul[0].cpu().numpy()
                alt = alt[0].cpu().numpy()
                for wi, it in enumerate(g):
                    results[id(it)] = (float(nul[wi]), float(alt[wi]))
        return results

    def paths_dispatch(self, items: list[PairItem]) -> list:
        """Trellis + device walk for every survivor of one wave: survivors
        grouped by (profile, padded window length), each group chunked
        within PATH_BATCH_BYTES and run as viterbi_path_batch calls, the
        batch padded to a power of two; the walk reads the trellis (row 0
        dropped) in place.  Returns the un-fetched path entries, with at
        most PATH_BATCH_BYTES of trellis in flight
        (`dispatch_paths_bounded`)."""
        return dispatch_paths_bounded(self._path_launches(items),
                                      self.PATH_BATCH_BYTES, self.metrics)

    def _path_launches(self, items: list[PairItem]):
        """Yields (trellis bytes, launch) for each chunk of survivors."""
        groups: dict[tuple[int, int], list[PairItem]] = {}
        for it in items:
            groups.setdefault((it.p_idx, _pad_len(it.win.length)),
                              []).append(it)
        for (p_idx, Lpad), group in groups.items():
            per = Lpad * (2 * self.K[p_idx] + 8)
            chunk = max(1, self.PATH_BATCH_BYTES // max(per, 1))
            for i0 in range(0, len(group), chunk):
                sub = group[i0:i0 + chunk]
                yield (len(sub) * per, lambda p_idx=p_idx, Lpad=Lpad,
                       sub=sub: self._path_launch(p_idx, Lpad, sub))

    def _path_launch(self, p_idx: int, Lpad: int,
                     sub: list[PairItem]) -> tuple:
        t0 = time.perf_counter()
        K = self.K[p_idx]
        Bp = next_pow2(len(sub))
        codes = np.zeros((Bp, Lpad, 5), np.int32)
        xts = np.zeros((Bp, 13), np.float32)
        lengths = np.zeros((Bp,), np.int32)
        for b, it in enumerate(sub):
            codes[b, :it.win.length] = it.codes
            xts[b] = it.xt
            lengths[b] = it.win.length
        xt_t, codes_t, lens_t = _tensors(self.device, xts, codes, lengths)
        _, xn, nd = viterbi_path_batch(*self._dev[p_idx], xt_t, codes_t,
                                       lens_t)
        xn = xn[:, 1:].contiguous()  # row l-1 holds position l
        nd = nd[:, 1:].contiguous()
        n = len(sub)
        sts, szs, ns, oks = walk(
            xn, nd, torch.arange(n, dtype=torch.int32, device=self.device),
            lens_t[:n].contiguous(), Lpad + 4 * K + 64)
        self._wall("phase2_path", t0)
        return (sub, sts, szs, ns, oks, xn, nd, list(range(n)),
                lengths[:n].tolist())
