"""Batch scheduler: ragged (profile, window) pairs -> kernel launches.

Counterpart of deciphon_tpu/scan/scheduler.py on one device with packing
off, which is the reference's BucketedPairScorer built with a
`scorer_factory`: plain power-of-two Kp buckets, each scored through
`PairScorer.dispatch`.  The jax-free pieces of that module are reused as
they are: PairItem, build_batches, bucket_arrays_meta, next_pow2,
prev_pow2, quantize_nlb, _mass_p90, chunk_sizes, pad_groups, NCHUNK,
_Bucket, _ChainChunk, HBMLedger and PairScorer._lpt_pack.  What touches
the device is written here:

  * DeviceSeqCodes — the scan-resident START-indexed code table, built on
    the device from 1 byte/nt of uploaded bases;
  * PairScorer — one common-Kp table stack; phase-1 dispatch through the
    chain tier (B3) with its gang (B5) and carry (B8) over-cap tiers and
    the classic rung buckets (B1), and phase-2 trellis + traceback (B2 +
    walk);
  * BucketedPairScorer — profiles partitioned into Kp buckets, one
    PairScorer each, one host transfer per phase-1 wave.

Environment switches, read where the reference reads them:
DECIPHON_NO_CHAIN=1 sends every window to the classic buckets;
DECIPHON_CHAIN_SEG=1 sends over-cap windows to carry segments instead of
the gang.

Every scorer holds an explicit torch device; nothing falls back to the
CPU.  Tiers that are not ported (HBM-streamed tables, Kp > 5120) raise.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from deciphon_tpu.frame import FRAG_OFFSETS
from deciphon_tpu.ops.costs import ViterbiCosts
from deciphon_tpu.scan.scheduler import (NCHUNK, HBMLedger, PairItem,
                                         _Bucket, _ChainChunk, _mass_p90,
                                         bucket_arrays_meta, build_batches,
                                         chunk_sizes, next_pow2, pad_groups,
                                         prev_pow2, quantize_nlb)
from deciphon_tpu.scan.scheduler import PairScorer as _RefPairScorer

from ..ops import viterbi as vk
from ..ops.tables import common_kp, round_up, stack_tables
from ..ops.traceback import walk


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

    def gstart(self, s_idx: int, win_start: int) -> int:
        return self.offsets[s_idx] + win_start


def _tensors(device, *arrays):
    """Host metadata of one launch -> device tensors (a few KB)."""
    return [torch.from_numpy(a).to(device) for a in arrays]


# least-loaded bin packing of (item, blocks) into chain slots: the
# reference's staticmethod, which needs no instance
_lpt_pack = _RefPairScorer._lpt_pack


class PairScorer:
    """Scores scheduled pairs of one table stack with the port's kernels.

    Phase 1 ships per launch only window metadata against the scan-resident
    code table; the score kernels gather each window's codes themselves.
    `dispatch` routes as the reference does (scheduler.py:547-558): the
    chain tier by default (B3), over-cap windows to the mixed-profile gang
    (B5) or, under DECIPHON_CHAIN_SEG=1, to carry segments (B8), and the
    rest to the plain rung buckets (B1), which DECIPHON_NO_CHAIN=1 forces
    for everything.  Phase 2 runs the path kernel and the device walk,
    returning un-fetched step arrays."""

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

    def __init__(self, costs_list: list[ViterbiCosts],
                 device: torch.device | str, w: int = 8):
        self.device = torch.device(device)
        self.w = w
        self.Kp = common_kp(costs_list)
        if self.Kp > vk.MAX_KP:
            raise NotImplementedError(
                f"Kp={self.Kp} exceeds the ported kernels' {vk.MAX_KP} "
                "lanes: the HBM-table tier is ROADMAP B4")
        tables, tvecs = stack_tables(costs_list, self.Kp)
        self.tables = tables.to(self.device)
        self.tvecs = tvecs.to(self.device)
        self.dev_codes: DeviceSeqCodes | None = None
        self.metrics = None  # optional ScanMetrics for phase walls
        self._chain_pin: tuple[int, int, int] | None = None
        self._xt_lut = np.zeros((self.XT_LUT_CAP, 16), np.float32)
        self._xt_lut_idx: dict = {}
        self._xt_lut_dev: torch.Tensor | None = None

    def table_bytes(self) -> int:
        """Device bytes of this scorer's emission/transition tables."""
        return (self.tables.numel() + self.tvecs.numel()) * 4

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
        """The classic phase-1 kernel call (device-resident codes)."""
        pidx, xts, lens, starts = _tensors(self.device, pidx, xts, lens,
                                           starts)
        return vk.scores_pairs(pidx, self.tables, self.tvecs, xts, lens,
                               starts, self.dev_codes.dev)

    def dispatch(self, items: list[PairItem]) -> list:
        """Enqueue every launch of one wave without blocking.  The chain
        tier is the production path; the classic rung buckets take the
        chain overflow, and DECIPHON_NO_CHAIN=1 forces them for every
        window (ablations)."""
        if (self.CHAIN and items
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
            inflight.append((_ChainChunk(groups), alt, nul))
        return inflight

    def _invoke_scores_chained(self, pidx, sblk, wlen, gst, xti):
        """The chained phase-1 kernel call (B3)."""
        pidx, sblk, wlen, gst, xti = _tensors(self.device, pidx, sblk, wlen,
                                              gst, xti)
        return vk.scores_pairs_chained(pidx, self.tables, self.tvecs, sblk,
                                       wlen, gst, xti, self._xt_lut_dev,
                                       self.dev_codes.dev)

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
            cbig, csml, self._xt_lut_dev, self.dev_codes.dev)

    def _dispatch_gang(self, items: list[PairItem]) -> list:
        """Mixed-profile groups for over-cap windows (B5).  The reference
        picks its VMEM-table kernel when the bucket's tables fit
        MIXED_VMEM_TABLE_BUDGET (a TPU VMEM constant) and the HBM-table
        kernel otherwise; on the card every table is in HBM, so every
        gang group launches B5."""
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
                entries.append((_Bucket(nlb=nlb, groups=chunk, w=wg),
                                alt, nul))
        return entries

    def _invoke_scores_gang(self, pidx, xts, lens, starts):
        """Mixed-profile scoring call (one profile per slot)."""
        pidx, xts, lens, starts = _tensors(self.device, pidx, xts, lens,
                                           starts)
        return vk.scores_pairs_mixed(pidx, self.tables, self.tvecs, xts,
                                     lens, starts, self.dev_codes.dev)

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
            if isinstance(alt, torch.Tensor):
                t0 = time.perf_counter()
                alt, nul = alt.cpu().numpy(), nul.cpu().numpy()
                if self.metrics is not None:
                    self.metrics.add_wall("collect",
                                          time.perf_counter() - t0)
            self._collect_one((bucket, alt, nul), results)
        return results

    def score(self, items: list[PairItem]) -> dict[int, tuple[float, float]]:
        """Returns {id(item) -> (null_cost, alt_cost)}."""
        return self.collect(self.dispatch(items))

    # -- phase 2: path kernel + device traceback -----------------------

    def paths_group_dispatch(self, items: list[PairItem]) -> list:
        """Trellis + traceback for LRT survivors, without fetching.

        Returns entries (items, sts, szs, ns, oks, xn, nd, rows, lengths)
        for ops/traceback.py assemble_path_entries; the caller fetches the
        step arrays of a whole wave in one transfer."""
        if not items:
            return []
        m = self.metrics
        inflight = []
        for bucket in build_batches(items, vk.PATH_KAPPA, w=8):
            t0 = time.perf_counter()
            wb = bucket.w
            pidx, xts, lens, starts = bucket_arrays_meta(bucket,
                                                         self.dev_codes)
            pidx, xts, lens, starts = _tensors(self.device, pidx, xts, lens,
                                               starts)
            xn, nd = vk.paths_pairs(pidx, self.tables, self.tvecs, xts,
                                    lens, starts, self.dev_codes.dev,
                                    nlb=bucket.nlb)
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
            if m is not None:
                m.add_wall("phase2_path", time.perf_counter() - t0)
            inflight.append((flat_items, sts, szs, ns, oks, xnf, ndf,
                             rows, lengths))
        return inflight


def device_table_budget(device: torch.device | str) -> int:
    """Device bytes available for resident profile tables.

    DECIPHON_HBM_BUDGET overrides (bytes); otherwise the device's total
    memory minus a working reserve (codes, trellis, in-flight outputs),
    with 16 GB assumed for the CPU."""
    env = os.environ.get("DECIPHON_HBM_BUDGET")
    if env:
        return int(env)
    device = torch.device(device)
    if device.type == "cuda":
        _, limit = torch.cuda.mem_get_info(device)
    else:
        limit = 16 << 30
    reserve = max(int(limit * 0.25), 2 << 30)
    return max(limit - reserve, 1 << 30)


class BucketedPairScorer:
    """Partitions profiles into Kp buckets, one PairScorer each.

    Buckets are powers of two over Kp up to 2048, then multiples of 512
    (the reference's plain buckets, scheduler.py BucketedPairScorer; its
    lane-packed tiers never change products and are not ported yet).  A
    capacity ledger checks that every bucket's tables stay resident;
    streaming tables per wave is not ported and raises."""

    MAX_KP = vk.MAX_KP
    # Slot-width rule of the reference (w * Kp state-plane budget).  On
    # the card each window is its own CTA, so w only sets how many
    # windows share one launch.
    W_LANE_BUDGET = 128 * 2048

    @staticmethod
    def w_cap(kp: int) -> int:
        return 256 if kp <= 1024 else 128

    def __init__(self, costs_list: list[ViterbiCosts],
                 device: torch.device | str, hbm_budget: int | None = None):
        self.device = torch.device(device)
        buckets: dict[int, list[int]] = {}
        for i, c in enumerate(costs_list):
            kp = round_up(max(c.K + 2, 128), 128)
            b = next_pow2(kp)
            if b > 2048:
                b = round_up(kp, 512)
            if b > self.MAX_KP:
                raise NotImplementedError(
                    f"profile {i} (K={c.K}) needs Kp={b} > {self.MAX_KP}: "
                    "the HBM-table tier is ROADMAP B4")
            buckets.setdefault(b, []).append(i)

        self._map: dict[int, tuple[int, int]] = {}
        self.scorers: list[PairScorer] = []
        for b, idxs in sorted(buckets.items()):
            for local, gi in enumerate(idxs):
                self._map[gi] = (len(self.scorers), local)
            costs = [costs_list[i] for i in idxs]
            kp = common_kp(costs)
            wb = max(8, prev_pow2(min(self.w_cap(kp),
                                      self.W_LANE_BUDGET // kp)))
            self.scorers.append(PairScorer(costs, self.device, w=wb))

        self.ledger = HBMLedger(hbm_budget if hbm_budget is not None
                                else device_table_budget(self.device))
        if any(self.ledger.plan([s.table_bytes() for s in self.scorers])):
            raise NotImplementedError(
                f"profile tables ({sum(s.table_bytes() for s in self.scorers) / 2**30:.2f} GB) "
                f"exceed the device budget ({self.ledger.budget / 2**30:.2f} GB): "
                "streaming tables per wave is not ported (ROADMAP)")
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
        blocking; returns a handle for collect_all."""
        by_scorer, remap = self._split(items)
        try:
            return [(self.scorers[si], self.scorers[si].dispatch(group))
                    for si, group in by_scorer.items()]
        finally:
            self._restore(items, remap)

    def collect_all(self, pending) -> dict[int, tuple[float, float]]:
        """Fetch every bucket's outputs of one wave in ONE host transfer
        (all alt/null planes, (N, W) and chained (N, W, C), concatenated
        on the device; carry planes never leave it)."""
        flat = [a for _, inflight in pending for e in inflight
                for a in (e[1], e[2])]
        t0 = time.perf_counter()
        host = (torch.cat([a.reshape(-1) for a in flat]).cpu().numpy()
                if flat else np.zeros(0, np.float32))
        if self.metrics is not None:
            self.metrics.add_wall("collect", time.perf_counter() - t0)
        pos = 0
        results: dict[int, tuple[float, float]] = {}
        for scorer, inflight in pending:
            rebuilt = []
            for bucket, alt, nul in inflight:
                n = alt.numel()
                a = host[pos:pos + n].reshape(alt.shape)
                u = host[pos + n:pos + 2 * n].reshape(nul.shape)
                pos += 2 * n
                rebuilt.append((bucket, a, u))
            results.update(scorer.collect(rebuilt))
        return results

    def paths_dispatch(self, items: list[PairItem]) -> list:
        """Phase-2 trellis + walk dispatch through each sub-scorer's path
        kernel; returns un-fetched path entries (every tier here has a
        path kernel, so nothing is left over)."""
        by_scorer, remap = self._split(items)
        try:
            entries: list = []
            for si, group in by_scorer.items():
                entries.extend(self.scorers[si].paths_group_dispatch(group))
            return entries
        finally:
            self._restore(items, remap)

