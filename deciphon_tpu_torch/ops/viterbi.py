"""Frame Viterbi kernels of the scan: phase-1 scores (B1, its chain, gang
and carry modes B3, B5, B8, the large-K tier B4, the streamed gang B4m,
and the lane-packed B6 and B7) and phase-2 trellis (B2), each a CUDA
kernel with its plain PyTorch version beside it.

Counterparts in deciphon_tpu/ops/viterbi_pallas.py:

  * `scores_pairs`  <- viterbi_scores_pairs_from_starts (`_kernel_pending`,
    plain pairs form, with the `_ck_from_starts` gather fused);
  * `scores_pairs_large`  <- _gather_scores_pairs_hbm_jit
    (`_kernel_block_large`: B1's function for Kp > 5120, each window's DP
    state split over the shared memory of a thread-block cluster);
  * `scores_pairs_mixed`  <- _gather_scores_pairs_mixed_vmem_jit
    (`_kernel_pending` mixed: one profile per slot, the gang tier);
  * `scores_pairs_mixed_large`  <- _gather_scores_pairs_hbm_mixed_jit
    (`_kernel_block_large` mixed: B5's function on B4's clusters, the gang
    of a scorer whose tables stream);
  * `scores_pairs_chained`  <- viterbi_scores_pairs_chained
    (`_kernel_pending` chain: C windows per slot, `_chain_expand` and
    `_chain_compact` fused);
  * `scores_pairs_chained_carry` and `carry_permute`  <-
    viterbi_scores_pairs_chained_carry and `_carry_permute_jit`
    (`_kernel_pending` carry: segmented windows);
  * `scores_pairs_packed`  <- viterbi_scores_pairs_packed
    (`_kernel_pending_packed`: NSEG profiles side by side on one plane,
    tables from ops/tables.py build_tables_packed);
  * `scores_pairs_packed_chained`  <- viterbi_scores_pairs_packed_chained
    (`_kernel_pending_packed` chain: a shared chain of code runs per slot,
    per-segment window lists; `_chain_expand`, `_iseg_window_expand` and
    the end-block compaction fused);
  * `paths_pairs`   <- viterbi_paths_pairs (`_kernel_path`, with the
    `_ck_end_from_starts` gather fused);
  * `scores_grid` and `GridScanEngine`  <- viterbi_scores_grid and
    PallasScanEngine (`_kernel`, the pull-form score kernel, in every
    gather mode: B1's function over a dense grid of profiles x windows,
    on the score body of B1 and B4).

Shared contract: `tables` (P, 1364, Kp) f32 and `tvecs` (P, 8, Kp) f32 from
ops/tables.py; per pair `pidx` (N,) int32; per (pair, slot) `xts`
(N, W, 16) f32, `lengths` (N, W, 1) int32 (0 = pad slot) and `starts`
(N, W) int32 row offsets into the scan-resident START-indexed code table
`codes_all` (T, 5) int32 (scan/scheduler.py DeviceSeqCodes).

Each wrapper picks by the device of its tensors: CPU tensors run the plain
version, CUDA tensors launch the kernel (built from csrc/ on first use) or
raise.  `LAUNCHES` counts kernel launches per wrapper, and only those (the
amino Forward and posterior of hmmer/forward.py count here too).
The score family (B1, B3, B5, B8, B4, B4m, B9) and B2 take their launch
shape from `cluster_shape` (one CTA per window up to Kp 2048, a cluster of
CTAs past it), B6 and B7 from `packed_shape`; `SHAPES` keeps each launched
shape with its resident cluster count (B6, B7: CTAs an SM holds at once).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..frame import TABLE_SIZE
from ..xtrans import (XT_CC, XT_CT, XT_EB, XT_EC, XT_EJ, XT_ET,
                                 XT_JB, XT_JJ, XT_NB, XT_NN, XT_RR, XT_SB,
                                 XT_SN)

from .tables import (TV_BM, TV_DDCUM, TV_DMS, TV_II, TV_IMS, TV_MD, TV_MI,
                     TV_MMS, common_kp, packed_width, stack_tables)

INF = float("inf")
# Length quanta of the scheduler's buckets: phase-1 windows are bucketed by
# 40-position blocks (viterbi_pallas.KAPPA_PENDING), phase-2 trellises hold
# nlb * 32 rows (scheduler.PairScorer.PATH_KAPPA).
KAPPA = 40
PATH_KAPPA = 32
# Widest lane plane of B1, B3, B5, B8 and the packed tiers' inner scorers:
# the scheduler's plain buckets end here (its MAX_KP), wider ones take the
# large-K tier.  Past Kp 2048 these kernels run on clusters, as B4 does.
MAX_KP = 5120
# The large-K tier (B4) and B2 take planes up to the bucket of the
# reference's largest profile, K = 16384 (c-core/model.h:12):
# round_up(round_up(16386, 128), 512).
MAX_LARGE_KP = 16896
# DP-state bytes per (slot, lane) of the reference's HBM-table kernel
# (viterbi_pallas.HBM_STATE_BYTES_PER_LANE): the scheduler's large-K slot
# width follows it.  Tuned for a TPU's VMEM and inherited, as the
# scheduler's PACK_* constants are.
HBM_STATE_BYTES_PER_LANE = 92
CW = 8  # carry slots per pair of the carry mode (viterbi_pallas.CW)
# Packed planes: at most this many lanes (the scheduler's PACK_KP_MAX),
# segments of a multiple of this many lanes.
PACK_MAX_KP = 2048
PACK_SEG_QUANTUM = 64

LAUNCHES = {"score": 0, "chain": 0, "gang": 0, "carry": 0, "large": 0,
            "gang_large": 0, "packed": 0, "pchain": 0, "path": 0, "grid": 0,
            "walk": 0, "amino_forward": 0, "amino_posterior": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# Launch shapes of the redesigned bodies.  Up to FAST_MAX_KP lanes a
# window runs in one CTA at LPT lanes a thread (the score body 2 up to
# SCORE_LPT2_MAX_KP, B2 2 up to PATH_LPT2_MAX_KP, 4 beyond); past it on a
# thread-block cluster of c CTAs of w lanes each, LPT 4, w a multiple of
# 128 (so that only the last rank has dead warps).  c aims at
# CLUSTER_TARGET_W[body] lanes a CTA, the band's fastest share on one H100
# 80GB HBM3 at 700.00 W (PERF.md §6, PRs 8 and 17; fewer lanes a CTA
# shorten each position's own work, more CTAs lengthen its exchanges),
# within MAX_CLUSTER; a share stays under 1408 lanes, 352 threads, inside
# both clustered kernels' thread bounds (B2's is 384, which leaves it
# enough registers not to spill).  The score body's plain buckets (to
# MAX_KP) take 512 lanes, for every kernel of the body (B1/B3/B5/B8, B4,
# B4m, B9): its CTAs hold 128 registers a thread, so four 128-thread CTAs
# share an SM where two of 192 do, and more windows are resident
# (`scripts/score_band_compare.py`, its "wide" times at 768, PR 17).
SMEM_BYTES = 232_448  # shared memory one CTA can use on an H100
SCORE_PLANES = 23  # csrc/viterbi_score.cu kFastPlanes
PACKED_PLANES = 23  # csrc/viterbi_packed.cu kPackedPlanes
# csrc/viterbi_packed.cu's static shared arrays (the exchange slots, the
# specials of 32 segments and the run table, 7440 B) fit in this many bytes
PACKED_STATIC_BYTES = 8 * 1024
PATH_PLANES = 28  # csrc/viterbi_path.cu kPathFastPlanes
FAST_MAX_KP = 2048
SCORE_LPT2_MAX_KP = 512
PATH_LPT2_MAX_KP = 1024
MAX_THREADS = 512
MAX_CLUSTER = 16
# body -> ((up to Kp, lanes a CTA), ...)
CLUSTER_TARGET_W = {
    "score": ((MAX_KP, 512), (6144, 768), (MAX_LARGE_KP, 1280)),
    "path": ((6144, 768), (MAX_LARGE_KP, 1280))}
SHAPES: dict = {}  # (LAUNCHES key, Kp) -> the launched shape's _asdict()
GRID_MAX_P = 65535  # B9's profiles a launch: the card's gridDim.y limit


class ClusterShape(NamedTuple):
    c: int  # CTAs a window
    w: int  # lanes a CTA (its planes' width)
    lpt: int  # lanes a thread
    threads: int  # threads a CTA
    smem: int  # dynamic shared bytes a CTA


def cluster_shape(Kp: int, body: str = "score") -> ClusterShape:
    """The launch shape of the score family, B1/B3/B5/B8/B4/B4m/B9
    (`body="score"`), or of B2 (`"path"`) at lane width Kp: rank r of a
    window's cluster owns lanes [r * w, min((r + 1) * w, Kp))."""
    if body not in CLUSTER_TARGET_W:
        raise ValueError(f"no clustered body {body!r}")
    if Kp <= FAST_MAX_KP:
        lpt2 = SCORE_LPT2_MAX_KP if body == "score" else PATH_LPT2_MAX_KP
        c, w, lpt = 1, Kp, 2 if Kp <= lpt2 else 4
    else:
        lpt = 4
        target = next(w for top, w in CLUSTER_TARGET_W[body] if Kp <= top)
        c = min(-(-Kp // target), MAX_CLUSTER)
        while True:
            w = -(-Kp // (128 * c)) * 128  # ceil(Kp / c) up to 128 lanes
            if (c - 1) * w < Kp:  # every rank holds live lanes
                break
            c -= 1
    planes = SCORE_PLANES if body == "score" else PATH_PLANES
    return ClusterShape(c, w, lpt, w // lpt, planes * w * 4)


class PackedShape(NamedTuple):
    lpt: int  # lanes a thread
    threads: int  # threads a CTA
    smem: int  # dynamic shared bytes a CTA


# B6 and B7 run LPT 2 lanes a thread up to this Kp and 4 beyond, the score
# body's band, chosen from the times of both on one H100 80GB HBM3 at the
# Pfam classes' planes (PERF.md section 6).
PACK_LPT2_MAX_KP = 512


def packed_shape(Kp: int, nseg: int) -> PackedShape:
    """The launch shape of B6 and B7 on a plane of `nseg` segments of Kp
    lanes: one CTA of Kp / lpt threads a (slot, entry, pair), segment s on
    threads [s * tps, (s + 1) * tps), tps = Kp / nseg / lpt, and the
    specials of every segment in warp 0 (nseg <= 32).  Raises on a plane
    the kernels do not take."""
    if (nseg <= 0 or Kp % 128 or not 0 < Kp <= PACK_MAX_KP or Kp % nseg
            or (Kp // nseg) % PACK_SEG_QUANTUM):
        raise NotImplementedError(
            f"Kp={Kp}, nseg={nseg}: packed planes take multiples of 128 "
            f"lanes up to {PACK_MAX_KP} in segments of a multiple of "
            f"{PACK_SEG_QUANTUM} lanes")
    lpt = 2 if Kp <= PACK_LPT2_MAX_KP else 4
    return PackedShape(lpt, Kp // lpt, PACKED_PLANES * Kp * 4)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when all are
    on the CPU; anything else is a caller error."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_kp(Kp: int, max_kp: int = MAX_KP) -> None:
    if Kp % 128 or Kp > max_kp:
        if max_kp < MAX_LARGE_KP:
            raise NotImplementedError(
                f"Kp={Kp}: these kernels take multiples of 128 up to "
                f"{max_kp} (wider profiles take the large-K tier, "
                "scores_pairs_large)")
        raise NotImplementedError(
            f"Kp={Kp}: the large-K tier takes multiples of 128 up to "
            f"{max_kp}, the bucket of the reference's largest profile "
            "(K <= 16384)")


def _check_inputs(pidx, tables, tvecs, xts, lengths, starts, codes_all,
                  mixed: bool = False, max_kp: int = MAX_KP):
    N, W = starts.shape
    P, _, Kp = tables.shape
    _check(pidx, "pidx", torch.int32, (N, W) if mixed else (N,))
    _check(tables, "tables", torch.float32, (P, TABLE_SIZE, Kp))
    _check(tvecs, "tvecs", torch.float32, (P, 8, Kp))
    _check(xts, "xts", torch.float32, (N, W, 16))
    _check(lengths, "lengths", torch.int32, (N, W, 1))
    _check(starts, "starts", torch.int32, (N, W))
    _check(codes_all, "codes_all", torch.int32, (codes_all.shape[0], 5))
    _check_kp(Kp, max_kp)
    return N, W, Kp


def _rows_setup(pidx, tables, tvecs, xts, lengths, starts):
    """Flattened per-(pair, slot) views shared by the plain versions."""
    N, W = starts.shape
    P, R, Kp = tables.shape
    flat = tables.reshape(P * R, Kp)
    base = (pidx.long() * R).repeat_interleave(W)  # (B,) table row base
    tv = tvecs[pidx.long()].repeat_interleave(W, dim=0)  # (B, 8, Kp)
    return (flat, base, tv, xts.reshape(N * W, 16),
            lengths.reshape(N * W).long(), starts.reshape(N * W).long())


# ---------------------------------------------------------------------------
# B1, B3, B5, B8: phase-1 scores
# ---------------------------------------------------------------------------


class _PendingDP:
    """DP state of B rows in the pending formulation, shared by the plain
    versions of the score kernels.  Before the step to position l, the
    queues hold what is pending for positions l .. l+4: QM/QI (5, B, Kp)
    for M/I and QS (4, 5, B) for N/J/C/R, entry i for position l + i
    (entry 4, never pushed yet, +inf).  Beside them the previous
    position's M/I/D (B, Kp), its raw pending N/J/C/R (4, B) and its
    specials [S B N J C E R] (B,).  The kernels keep the same values in
    5-slot rings indexed by position % 5 (the carry planes' layout)."""

    def __init__(self, B: int, Kp: int, dev, xt):
        self.QM = torch.full((5, B, Kp), INF, device=dev)
        self.QI = torch.full((5, B, Kp), INF, device=dev)
        self.QS = torch.full((4, 5, B), INF, device=dev)
        self.sm = torch.full((B, Kp), INF, device=dev)
        self.si, self.sd = self.sm.clone(), self.sm.clone()
        self.inf_b = torch.full((B,), INF, device=dev)
        self.inf_m = torch.full((1, B, Kp), INF, device=dev)
        self.inf_s = torch.full((4, 1, B), INF, device=dev)
        self.qs_prev = torch.full((4, B), INF, device=dev)
        self.ss = self._seeds(xt)

    def _seeds(self, xt):
        return [torch.zeros_like(self.inf_b), xt[:, XT_SB], self.inf_b,
                self.inf_b, self.inf_b, self.inf_b, -xt[:, XT_RR]]

    def reseed(self, rows, xt) -> None:
        """Restart the rows where `rows` (B,) bool holds, from position 0
        of a window with xtrans `xt` (B, 16)."""
        r2 = rows[:, None]
        self.QM = torch.where(r2, INF, self.QM)
        self.QI = torch.where(r2, INF, self.QI)
        self.QS = torch.where(rows, INF, self.QS)
        self.sm = torch.where(r2, INF, self.sm)
        self.si = torch.where(r2, INF, self.si)
        self.sd = torch.where(r2, INF, self.sd)
        self.qs_prev = torch.where(rows, INF, self.qs_prev)
        self.ss = [torch.where(rows, a, b)
                   for a, b in zip(self._seeds(xt), self.ss)]

    def load(self, rows, big, sml) -> None:
        """Resume the rows where `rows` holds, before position 1, from
        carry planes big (B, 13, Kp) = PM | PI | ST and sml (B, 32) =
        PSM | SS | 0 exported at a position = 0 (mod 5): ring slot s holds
        position s (mod 5), so queue entries 0..3 are slots 1..4."""
        r2 = rows[:, None]
        order = [1, 2, 3, 4]
        qm = torch.cat([big[:, order].transpose(0, 1), self.inf_m])
        qi = torch.cat([big[:, [5 + s for s in order]].transpose(0, 1),
                        self.inf_m])
        psm = sml[:, 0:20].T.reshape(4, 5, -1)
        qs = torch.cat([psm[:, order], self.inf_s], 1)
        self.QM = torch.where(r2, qm, self.QM)
        self.QI = torch.where(r2, qi, self.QI)
        self.QS = torch.where(rows, qs, self.QS)
        self.sm = torch.where(r2, big[:, 10], self.sm)
        self.si = torch.where(r2, big[:, 11], self.si)
        self.sd = torch.where(r2, big[:, 12], self.sd)
        self.qs_prev = torch.where(rows, psm[:, 0], self.qs_prev)
        self.ss = [torch.where(rows, sml[:, 20 + j], self.ss[j])
                   for j in range(7)]

    def export(self, l: int):
        """Carry planes of every row after position l: (big (B, 13, Kp),
        sml (B, 32)), ring slot (l + i) % 5 holding position l + i."""
        order = [(i - l) % 5 for i in range(5)]  # slot -> queue position
        pm = torch.stack([self.sm, *self.QM[:4]])[order]
        pi = torch.stack([self.si, *self.QI[:4]])[order]
        psm = torch.cat([self.qs_prev[:, None], self.QS[:, :4]], 1)[:, order]
        big = torch.cat([pm.transpose(0, 1), pi.transpose(0, 1),
                         torch.stack([self.sm, self.si, self.sd], 1)], 1)
        B = self.sm.shape[0]
        sml = torch.cat([psm.reshape(20, B).T, torch.stack(self.ss, 1),
                         torch.zeros((B, 5), device=big.device)], 1)
        return big, sml

    def step(self, rows, tv, xt):
        """Advance every row one DP position: `rows` (5, B, Kp) are the
        emission rows of the 5 fragments starting there (fragment t + 1
        ends at queue entry t), tv (B, 8, Kp) and xt (B, 16) each row's
        transitions.  Returns (T_l, R_l) (B,)."""
        sm, si, sd, ss = self.sm, self.si, self.sd, self.ss
        Kp = sm.shape[1]

        def x(j):
            return xt[:, j]

        inner = torch.minimum(torch.minimum(sm + tv[:, TV_MMS],
                                            si + tv[:, TV_IMS]),
                              sd + tv[:, TV_DMS])
        contrib = torch.minimum(torch.roll(inner, 1, -1),
                                ss[1][:, None] + tv[:, TV_BM])
        icand = torch.minimum(si + tv[:, TV_II], sm + tv[:, TV_MI])
        cN = torch.minimum(ss[0] + x(XT_SN), ss[2] + x(XT_NN))
        cJ = torch.minimum(ss[5] + x(XT_EJ), ss[3] + x(XT_JJ))
        cC = torch.minimum(ss[5] + x(XT_EC), ss[4] + x(XT_CC))
        cR = ss[6]
        # push: entry 4 is +inf, so its min is the kernels' fresh
        # assignment of the ring slot consumed at l-1
        QM = torch.minimum(self.QM, contrib + rows)
        QI = torch.minimum(self.QI, icand + rows[:, :, Kp - 1:Kp])
        QS = torch.minimum(self.QS, torch.stack((cN, cJ, cC, cR))[:, None]
                           + rows[:, :, Kp - 2])

        M, I = QM[0], QI[0]
        A = torch.roll(M, 1, -1) + tv[:, TV_MD]
        D = (torch.cummin(A - tv[:, TV_DDCUM], dim=-1).values
             + tv[:, TV_DDCUM])
        E = torch.minimum(M.amin(-1), D.amin(-1))
        Nl, Jl, Cl = QS[0, 0], QS[1, 0], QS[2, 0]
        R = QS[3, 0] + x(XT_RR)
        Bl = torch.minimum(torch.minimum(Nl + x(XT_NB), E + x(XT_EB)),
                           Jl + x(XT_JB))
        Tl = torch.minimum(E + x(XT_ET), Cl + x(XT_CT))
        self.sm, self.si, self.sd = M, I, D
        self.qs_prev = QS[:, 0]
        self.ss = [self.inf_b, Bl, Nl, Jl, Cl, E, R]
        # consume entry 0: the queues move on by one position
        self.QM = torch.cat([QM[1:], self.inf_m])
        self.QI = torch.cat([QI[1:], self.inf_m])
        self.QS = torch.cat([QS[:, 1:], self.inf_s], 1)
        return Tl, R


def _emission_rows(flat, base, codes_all, crow):
    """The emission rows (5, B, Kp) of the fragments starting at code rows
    `crow` (B,), of the profiles whose table rows start at `base` (B,)."""
    codes = codes_all[crow].long()  # (B, 5)
    return flat[(base[:, None] + codes).T]


def _scores_windows_plain(flat, base, tv, xt, lens, st, codes_all):
    """One window per row: base (B,) table row offset, tv (B, 8, Kp), xt
    (B, 16), lens and st (B,) int64.  Every window runs to its full
    length, as on the card; returns (alt, null) (B,), +inf for lens 0."""
    B, Kp = xt.shape[0], flat.shape[1]
    T = codes_all.shape[0]
    dp = _PendingDP(B, Kp, flat.device, xt)
    Tfin, Rfin = dp.inf_b.clone(), dp.inf_b.clone()
    ends = set(lens.tolist())
    for l in range(1, max(ends, default=0) + 1):
        rows = _emission_rows(flat, base, codes_all,
                              (st + (l - 1)).clamp(max=T - 1))
        Tl, R = dp.step(rows, tv, xt)
        if l in ends:
            at_end = lens == l
            Tfin = torch.where(at_end, Tl, Tfin)
            Rfin = torch.where(at_end, R, Rfin)
    return Tfin, Rfin


def scores_pairs_plain(pidx, tables, tvecs, xts, lengths, starts, codes_all):
    """Plain PyTorch B1: the pending formulation of `_kernel_pending`, one
    Python step per DP position over (N*W, Kp) planes, in the kernel's f32
    operation order.  Every window runs to its full length, as on the card.
    Returns (alt, null) (N, W) f32; pad slots +inf."""
    N, W = starts.shape
    flat, base, tv, xt, lens, st = _rows_setup(pidx, tables, tvecs, xts,
                                               lengths, starts)
    alt, nul = _scores_windows_plain(flat, base, tv, xt, lens, st,
                                     codes_all)
    return alt.reshape(N, W), nul.reshape(N, W)


def scores_pairs(pidx, tables, tvecs, xts, lengths, starts, codes_all):
    """B1 wrapper: (alt, null) (N, W) f32 min-plus costs per window.  The
    fused gather reads each window's codes itself, so no block count is
    needed: a window runs to its length."""
    _check_inputs(pidx, tables, tvecs, xts, lengths, starts, codes_all)
    if not on_cuda(pidx, tables, tvecs, xts, lengths, starts, codes_all):
        return scores_pairs_plain(pidx, tables, tvecs, xts, lengths, starts,
                                  codes_all)
    return _launch_pairs("dtt_score_pairs", "score", pidx, tables, tvecs,
                         xts, lengths, starts, codes_all)


def _launch_shaped(fn: str, key: str, Kp: int, shape, *args) -> None:
    """Call an entry point that takes its launch shape (the score family
    and B2 `cluster_shape`, B6 and B7 `packed_shape`) with `args` before
    it; the shape and what is resident at once (clusters, 0 when c = 1;
    B6, B7: CTAs an SM) go into SHAPES.  A shape the entry point does not
    take, or that cannot be resident, is refused there, and raises here."""
    from .. import _build

    active = ctypes.c_int(0)
    dev = args[1].device
    with torch.cuda.device(dev):
        err = getattr(_build.lib(), fn)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args],
            *shape, ctypes.byref(active),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"{fn} (shape {tuple(shape)})")
    LAUNCHES[key] += 1
    SHAPES[(key, Kp)] = dict(shape._asdict(), active=active.value)


def _launch_pairs(fn: str, key: str, pidx, tables, tvecs, xts, lengths,
                  starts, codes_all):
    """One B1, B5, B4 or B4m launch: (alt, null) (N, W) f32, each window's
    DP state in the shared memory of its CTA or cluster."""
    N, W = starts.shape
    Kp = tables.shape[2]
    alt = torch.empty((N, W), dtype=torch.float32, device=tables.device)
    nul = torch.empty_like(alt)
    _launch_shaped(fn, key, Kp, cluster_shape(Kp), pidx, tables, tvecs, xts,
                   lengths, starts, codes_all, alt, nul, N, W, Kp,
                   codes_all.shape[0])
    return alt, nul


def scores_pairs_large(pidx, tables, tvecs, xts, lengths, starts,
                       codes_all):
    """B4 wrapper, the large-K tier: `scores_pairs`' contract for lane
    planes up to MAX_LARGE_KP.  (alt, null) (N, W) f32, pad slots +inf.
    The function is B1's, so the plain version is `scores_pairs_plain`,
    kept once; on the card it launches through B1's entry point, a window
    past Kp 2048 on a cluster."""
    _check_inputs(pidx, tables, tvecs, xts, lengths, starts, codes_all,
                  max_kp=MAX_LARGE_KP)
    if not on_cuda(pidx, tables, tvecs, xts, lengths, starts, codes_all):
        return scores_pairs_plain(pidx, tables, tvecs, xts, lengths, starts,
                                  codes_all)
    return _launch_pairs("dtt_score_pairs", "large", pidx, tables,
                         tvecs, xts, lengths, starts, codes_all)


def scores_pairs_mixed_plain(pidx, tables, tvecs, xts, lengths, starts,
                             codes_all):
    """Plain PyTorch B5: B1 with one profile per (pair, slot), pidx
    (N, W).  Returns (alt, null) (N, W) f32; pad slots +inf."""
    N, W = starts.shape
    P, R, Kp = tables.shape
    p = pidx.reshape(N * W).long()
    alt, nul = _scores_windows_plain(
        tables.reshape(P * R, Kp), p * R, tvecs[p], xts.reshape(N * W, 16),
        lengths.reshape(N * W).long(), starts.reshape(N * W).long(),
        codes_all)
    return alt.reshape(N, W), nul.reshape(N, W)


def scores_pairs_mixed(pidx, tables, tvecs, xts, lengths, starts,
                       codes_all):
    """B5 wrapper (the gang tier): as `scores_pairs` with pidx (N, W), one
    profile per slot.  Returns (alt, null) (N, W) f32."""
    _check_inputs(pidx, tables, tvecs, xts, lengths, starts, codes_all,
                  mixed=True)
    if not on_cuda(pidx, tables, tvecs, xts, lengths, starts, codes_all):
        return scores_pairs_mixed_plain(pidx, tables, tvecs, xts, lengths,
                                        starts, codes_all)
    return _launch_pairs("dtt_score_mixed", "gang", pidx, tables, tvecs,
                         xts, lengths, starts, codes_all)


def scores_pairs_mixed_large(pidx, tables, tvecs, xts, lengths, starts,
                             codes_all):
    """B4m wrapper (the gang of a scorer whose tables stream):
    `scores_pairs_mixed`' contract, pidx (N, W), for lane planes up to
    MAX_LARGE_KP.  The function is B5's, so the plain version is
    `scores_pairs_mixed_plain`, kept once; on the card it launches through
    B5's entry point: one CTA a window up to Kp 2048, a cluster past it.
    Returns (alt, null) (N, W) f32."""
    _check_inputs(pidx, tables, tvecs, xts, lengths, starts, codes_all,
                  mixed=True, max_kp=MAX_LARGE_KP)
    if not on_cuda(pidx, tables, tvecs, xts, lengths, starts, codes_all):
        return scores_pairs_mixed_plain(pidx, tables, tvecs, xts, lengths,
                                        starts, codes_all)
    return _launch_pairs("dtt_score_mixed", "gang_large", pidx,
                         tables, tvecs, xts, lengths, starts, codes_all)


def _check_chain(pidx, tables, tvecs, win_sblk, win_len, win_gstart,
                 win_xti, xt_lut, codes_all):
    N, W, C = win_len.shape
    P, _, Kp = tables.shape
    _check(pidx, "pidx", torch.int32, (N,))
    _check(tables, "tables", torch.float32, (P, TABLE_SIZE, Kp))
    _check(tvecs, "tvecs", torch.float32, (P, 8, Kp))
    for name, a in (("win_sblk", win_sblk), ("win_len", win_len),
                    ("win_gstart", win_gstart), ("win_xti", win_xti)):
        _check(a, name, torch.int32, (N, W, C))
    _check(xt_lut, "xt_lut", torch.float32, (xt_lut.shape[0], 16))
    _check(codes_all, "codes_all", torch.int32, (codes_all.shape[0], 5))
    _check_kp(Kp)
    return N, W, C, Kp


def _chain_plain(pidx, tables, tvecs, win_sblk, win_len, win_gstart,
                 win_xti, xt_lut, codes_all, carry=None):
    """Chained scoring in chain coordinates, as `_chain_expand` lays it
    out: each (pair, slot) row runs positions l = 1.. of its chain; at the
    first block of an entry the row is reseeded (or, for a continuing
    entry 0, loaded from `carry`), xtrans and code rows follow the entry
    that covers the block, and T/R latch at the entry's chain-coordinate
    end sblk * KAPPA + len.  carry = (conts (B,) bool, big (B, 13, Kp),
    sml (B, 32)) also exports, per row, the state after entry 0's end.
    Returns (alt, null) (B, C) and the exported planes or None."""
    N, W, C = win_len.shape
    P, R, Kp = tables.shape
    B = N * W
    T = codes_all.shape[0]
    dev = tables.device
    flat = tables.reshape(P * R, Kp)
    base = (pidx.long() * R).repeat_interleave(W)
    tv = tvecs[pidx.long()].repeat_interleave(W, dim=0)
    sblk, wlen, gst, xti = (a.reshape(B, C).long() for a in
                            (win_sblk, win_len, win_gstart, win_xti))
    real = wlen > 0
    end_blk = sblk + (wlen + KAPPA - 1) // KAPPA
    end = torch.where(real, sblk * KAPPA + wlen, 0)
    alt = torch.full((B, C), INF, device=dev)
    nul = torch.full((B, C), INF, device=dev)
    xt = xt_lut[xti[:, 0]]
    dp = _PendingDP(B, Kp, dev, xt)
    exported = None
    end0 = end[:, 0]
    # latch and export positions, read once so the loop never waits on
    # the device
    ends, ends0 = set(end[real].tolist()), set(end0[real[:, 0]].tolist())
    rowi = torch.arange(B, device=dev)
    for l in range(1, max(ends, default=0) + 1):
        if (l - 1) % KAPPA == 0:  # a new block: find each row's entry
            b = (l - 1) // KAPPA
            cov = real & (sblk <= b) & (b < end_blk)
            active = cov.any(1)
            ci = cov.int().argmax(1)  # entries are disjoint
            s_act = sblk[rowi, ci]
            xt = xt_lut[xti[rowi, ci]]
            off = gst[rowi, ci] - s_act * KAPPA
            starting = active & (s_act == b)
            if carry is not None and l == 1:
                conts, big, sml = carry
                dp.reseed(starting & ~conts, xt)
                dp.load(conts, big, sml)
            else:
                dp.reseed(starting, xt)
        crow = (off + (l - 1)).clamp(0, T - 1)
        Tl, Rl = dp.step(_emission_rows(flat, base, codes_all, crow), tv,
                         xt)
        if l in ends:  # entries are disjoint: one ends here per row
            hit = end == l
            alt = torch.where(hit, Tl[:, None], alt)
            nul = torch.where(hit, Rl[:, None], nul)
        if carry is not None and l in ends0:
            big, sml = dp.export(l)
            at = (end0 == l)[:, None]
            if exported is None:
                exported = (torch.zeros_like(big), torch.zeros_like(sml))
            exported = (torch.where(at[:, :, None], big, exported[0]),
                        torch.where(at, sml, exported[1]))
    return alt, nul, exported


def scores_pairs_chained_plain(pidx, tables, tvecs, win_sblk, win_len,
                               win_gstart, win_xti, xt_lut, codes_all):
    """Plain PyTorch B3 (see `scores_pairs_chained`): one Python step per
    chain-coordinate position over (N*W, Kp) planes.  Returns (alt, null)
    (N, W, C) f32; pad entries +inf."""
    N, W, C = win_len.shape
    alt, nul, _ = _chain_plain(pidx, tables, tvecs, win_sblk, win_len,
                               win_gstart, win_xti, xt_lut, codes_all)
    return alt.reshape(N, W, C), nul.reshape(N, W, C)


def scores_pairs_chained(pidx, tables, tvecs, win_sblk, win_len,
                         win_gstart, win_xti, xt_lut, codes_all):
    """B3 wrapper: score N pairs of W slots, each slot a chain of up to C
    windows.  Entry (n, w, c) is a window of win_len nt (0 = pad) whose
    codes start at row win_gstart of `codes_all`, with xtrans row
    xt_lut[win_xti] (xt_lut (X, 16) f32), placed at block win_sblk of its
    slot's chain (KAPPA-position blocks).  Contract (the scheduler's, as
    in the reference): the entries of one slot are disjoint and in block
    order, each starting at or after the previous one's last block + 1.
    Returns (alt, null) (N, W, C) f32; pad entries +inf.  Every real
    entry equals the same window scored by `scores_pairs`.  The kernel
    scores each entry from its own reseed and does not read win_sblk."""
    N, W, C, Kp = _check_chain(pidx, tables, tvecs, win_sblk, win_len,
                               win_gstart, win_xti, xt_lut, codes_all)
    args = (pidx, tables, tvecs, win_sblk, win_len, win_gstart, win_xti,
            xt_lut, codes_all)
    if not on_cuda(*args):
        return scores_pairs_chained_plain(*args)
    alt = torch.empty((N, W, C), dtype=torch.float32, device=tables.device)
    nul = torch.empty_like(alt)
    _launch_shaped("dtt_score_chained", "chain", Kp, cluster_shape(Kp), pidx,
                   tables, tvecs, win_len, win_gstart, win_xti, xt_lut,
                   codes_all, alt, nul, N, W, C, Kp, codes_all.shape[0])
    return alt, nul


def scores_pairs_chained_carry_plain(pidx, tables, tvecs, win_sblk, win_len,
                                     win_gstart, win_xti, conts, cbig_in,
                                     csml_in, xt_lut, codes_all):
    """Plain PyTorch B8 (see `scores_pairs_chained_carry`).  Returns
    (alt, null (N, W, C), cbig_out (N, 13, CW, Kp), csml_out
    (N, 32, CW, 1)); planes of slots it does not define are 0."""
    N, W, C = win_len.shape
    Kp = tables.shape[2]
    B = N * W
    dev = tables.device
    slot = torch.arange(W, device=dev).repeat(N)
    cw = slot < CW
    big = torch.zeros((B, 13, Kp), device=dev)
    sml = torch.zeros((B, 32), device=dev)
    big.view(N, W, 13, Kp)[:, :CW] = cbig_in.transpose(1, 2)[:, :W]
    sml.view(N, W, 32)[:, :CW] = csml_in[..., 0].transpose(1, 2)[:, :W]
    cont = (conts.reshape(B) > 0) & cw
    alt, nul, out = _chain_plain(pidx, tables, tvecs, win_sblk, win_len,
                                 win_gstart, win_xti, xt_lut, codes_all,
                                 carry=(cont, big, sml))
    cbig = torch.zeros((N, 13, CW, Kp), device=dev)
    csml = torch.zeros((N, 32, CW, 1), device=dev)
    if out is not None:
        defined = (cw & (win_len.reshape(B, C)[:, 0] > 0)).reshape(N, W)
        ob, osml = out[0].reshape(N, W, 13, Kp), out[1].reshape(N, W, 32)
        for w in range(min(W, CW)):
            d = defined[:, w]
            cbig[d, :, w] = ob[d, w]
            csml[d, :, w, 0] = osml[d, w]
    return alt.reshape(N, W, C), nul.reshape(N, W, C), cbig, csml


def scores_pairs_chained_carry(pidx, tables, tvecs, win_sblk, win_len,
                               win_gstart, win_xti, conts, cbig_in, csml_in,
                               xt_lut, codes_all):
    """B8 wrapper: `scores_pairs_chained` with DP carry across consecutive
    calls, for windows split into segments.  conts (N, W) int32 flags the
    slots w < CW whose entry 0 continues a window: it starts from the
    carry planes cbig_in (N, 13, CW, Kp) = PM[0:5] | PI[5:10] | ST[10:13]
    and csml_in (N, 32, CW, 1) = PSM.reshape(20) | SS[20:27] | 0 (the
    reference's layout; route them from the previous call with
    `carry_permute`) instead of its reseed.  The kernel takes M and I of
    the previous position from ring slot 0 of PM/PI, which equal ST[0:2]
    in every exported plane (segments span whole blocks).  Returns (alt,
    null (N, W, C), cbig_out, csml_out): for each slot w < CW whose entry
    0 is real, the state after that entry's last position; the scheduler
    reads only slots whose chain is one segment, and other planes are
    undefined.  As in B3, only the plain version reads win_sblk."""
    N, W, C, Kp = _check_chain(pidx, tables, tvecs, win_sblk, win_len,
                               win_gstart, win_xti, xt_lut, codes_all)
    _check(conts, "conts", torch.int32, (N, W))
    _check(cbig_in, "cbig_in", torch.float32, (N, 13, CW, Kp))
    _check(csml_in, "csml_in", torch.float32, (N, 32, CW, 1))
    args = (pidx, tables, tvecs, win_sblk, win_len, win_gstart, win_xti,
            conts, cbig_in, csml_in, xt_lut, codes_all)
    if not on_cuda(*args):
        return scores_pairs_chained_carry_plain(*args)
    alt = torch.empty((N, W, C), dtype=torch.float32, device=tables.device)
    nul = torch.empty_like(alt)
    cbig = torch.empty_like(cbig_in)
    csml = torch.empty_like(csml_in)
    _launch_shaped("dtt_score_chained_carry", "carry", Kp, cluster_shape(Kp),
                   pidx, tables, tvecs, win_len, win_gstart, win_xti, xt_lut,
                   codes_all, conts, cbig_in, csml_in, cbig, csml, alt, nul,
                   N, W, C, Kp, codes_all.shape[0])
    return alt, nul, cbig, csml


def carry_permute(cbig, csml, route):
    """Route carry planes between consecutive segment calls: slot
    (n, w) of the result is flat slot route[n * CW + w] (= n' * CW + w')
    of the previous call's (cbig (Ns, 13, CW, Kp), csml (Ns, 32, CW, 1)).
    A plain index op on the planes' device (the counterpart of
    `_carry_permute_jit`); route (Nd * CW,) int."""
    Ns, _, _, Kp = cbig.shape
    Nd = route.numel() // CW
    idx = route.to(device=cbig.device, dtype=torch.long)
    big = cbig.transpose(1, 2).reshape(Ns * CW, 13, Kp)[idx]
    sml = csml.transpose(1, 2).reshape(Ns * CW, 32, 1)[idx]
    return (big.reshape(Nd, CW, 13, Kp).transpose(1, 2).contiguous(),
            sml.reshape(Nd, CW, 32, 1).transpose(1, 2).contiguous())


# ---------------------------------------------------------------------------
# B6, B7: lane-packed phase-1 scores
# ---------------------------------------------------------------------------


class _PackedPendingDP:
    """`_PendingDP` for packed planes: B rows of Kp = S * seg lanes, segment
    s on lanes [s * seg, (s + 1) * seg).  M/I/D planes are (B, Kp) as
    there; the special states, their pending queues and the xtrans rows
    are per (row, segment): ss entries (B, S), QS (4, 5, B, S), xt
    (B, S, 16).  Every segment starts idle (+inf everywhere) until
    `reseed` starts a window on it."""

    def __init__(self, B: int, Kp: int, S: int, dev):
        self.S, self.seg = S, Kp // S
        self.QM = torch.full((5, B, Kp), INF, device=dev)
        self.QI = torch.full((5, B, Kp), INF, device=dev)
        self.QS = torch.full((4, 5, B, S), INF, device=dev)
        self.sm = torch.full((B, Kp), INF, device=dev)
        self.si, self.sd = self.sm.clone(), self.sm.clone()
        self.inf_s = torch.full((B, S), INF, device=dev)
        self.inf_m = torch.full((1, B, Kp), INF, device=dev)
        self.inf_q = torch.full((4, 1, B, S), INF, device=dev)
        self.ss = [self.inf_s] * 7

    def lanes(self, v):
        """(B, S) per-segment values -> (B, Kp), each over its lanes."""
        B = v.shape[0]
        return v[:, :, None].expand(B, self.S, self.seg).reshape(B, -1)

    def reseed(self, rows, xt) -> None:
        """Restart the segments where `rows` (B, S) bool holds, from
        position 0 of a window with xtrans `xt` (B, S, 16): only that
        segment's lanes clear."""
        rl = self.lanes(rows)
        self.QM = torch.where(rl, INF, self.QM)
        self.QI = torch.where(rl, INF, self.QI)
        self.QS = torch.where(rows, INF, self.QS)
        self.sm = torch.where(rl, INF, self.sm)
        self.si = torch.where(rl, INF, self.si)
        self.sd = torch.where(rl, INF, self.sd)
        seeds = [torch.zeros_like(self.inf_s), xt[:, :, XT_SB], self.inf_s,
                 self.inf_s, self.inf_s, self.inf_s, -xt[:, :, XT_RR]]
        self.ss = [torch.where(rows, a, b) for a, b in zip(seeds, self.ss)]

    def step(self, rows, tv, xt):
        """Advance every row one DP position: `rows` (5, B, 2 * Kp + 128)
        are the packed emission rows of the 5 fragments starting there, tv
        (B, 8, Kp), xt (B, S, 16).  Returns (T_l, R_l) (B, S).  The lane
        shift wraps and crosses segment boundaries unmasked, as in the
        kernels: the last lane of every segment is a +inf pad."""
        sm, si, sd, ss = self.sm, self.si, self.sd, self.ss
        B, Kp = sm.shape
        S, seg = self.S, self.seg

        def x(j):
            return xt[:, :, j]

        inner = torch.minimum(torch.minimum(sm + tv[:, TV_MMS],
                                            si + tv[:, TV_IMS]),
                              sd + tv[:, TV_DMS])
        contrib = torch.minimum(torch.roll(inner, 1, -1),
                                self.lanes(ss[1]) + tv[:, TV_BM])
        icand = torch.minimum(si + tv[:, TV_II], sm + tv[:, TV_MI])
        cN = torch.minimum(ss[0] + x(XT_SN), ss[2] + x(XT_NN))
        cJ = torch.minimum(ss[5] + x(XT_EJ), ss[3] + x(XT_JJ))
        cC = torch.minimum(ss[5] + x(XT_EC), ss[4] + x(XT_CC))
        cR = ss[6]
        QM = torch.minimum(self.QM, contrib + rows[:, :, :Kp])
        QI = torch.minimum(self.QI, icand + rows[:, :, Kp:2 * Kp])
        QS = torch.minimum(self.QS, torch.stack((cN, cJ, cC, cR))[:, None]
                           + rows[:, :, 2 * Kp:2 * Kp + S])

        M, I = QM[0], QI[0]
        A = torch.roll(M, 1, -1) + tv[:, TV_MD]
        ddc = tv[:, TV_DDCUM]
        # the delete-chain prefix min restarts at every segment
        D = (torch.cummin((A - ddc).reshape(B, S, seg), dim=-1).values
             .reshape(B, Kp) + ddc)
        E = torch.minimum(M, D).reshape(B, S, seg).amin(-1)
        Nl, Jl, Cl = QS[0, 0], QS[1, 0], QS[2, 0]
        R = QS[3, 0] + x(XT_RR)
        Bl = torch.minimum(torch.minimum(Nl + x(XT_NB), E + x(XT_EB)),
                           Jl + x(XT_JB))
        Tl = torch.minimum(E + x(XT_ET), Cl + x(XT_CT))
        self.sm, self.si, self.sd = M, I, D
        self.ss = [self.inf_s, Bl, Nl, Jl, Cl, E, R]
        self.QM = torch.cat([QM[1:], self.inf_m])
        self.QI = torch.cat([QI[1:], self.inf_m])
        self.QS = torch.cat([QS[:, 1:], self.inf_q], 1)
        return Tl, R


def _check_packed_tables(pidx, tables, tvecs, nseg: int, N: int) -> int:
    P, _, Kp = tvecs.shape
    _check(pidx, "pidx", torch.int32, (N,))
    _check(tables, "tables", torch.float32, (P, TABLE_SIZE, packed_width(Kp)))
    _check(tvecs, "tvecs", torch.float32, (P, 8, Kp))
    packed_shape(Kp, nseg)  # raises on a plane the kernels do not take
    return Kp


def scores_pairs_packed_plain(pidx, tables, tvecs, xts, lengths, starts,
                              codes_all, *, nseg):
    """Plain PyTorch B6: the pending formulation of
    `_kernel_pending_packed`, one Python step per DP position over
    (N*W, Kp) planes with per-segment specials, in the kernel's f32
    operation order.  Returns (alt, null) (N, W, nseg) f32; pad slots and
    empty segments +inf."""
    N, W = starts.shape
    P, R, Wt = tables.shape
    Kp, S, B = tvecs.shape[2], nseg, N * W
    T = codes_all.shape[0]
    dev = tables.device
    flat = tables.reshape(P * R, Wt)
    base = (pidx.long() * R).repeat_interleave(W)
    tv = tvecs[pidx.long()].repeat_interleave(W, dim=0)
    xt = xts.reshape(B, 1, 16).expand(B, S, 16)
    lens = lengths.reshape(B).long()
    st = starts.reshape(B).long()
    dp = _PackedPendingDP(B, Kp, S, dev)
    dp.reseed(torch.ones((B, S), dtype=torch.bool, device=dev), xt)
    alt = torch.full((B, S), INF, device=dev)
    nul = torch.full((B, S), INF, device=dev)
    ends = set(lens.tolist())
    for l in range(1, max(ends, default=0) + 1):
        rows = _emission_rows(flat, base, codes_all,
                              (st + (l - 1)).clamp(max=T - 1))
        Tl, Rl = dp.step(rows, tv, xt)
        if l in ends:
            at_end = (lens == l)[:, None]
            alt = torch.where(at_end, Tl, alt)
            nul = torch.where(at_end, Rl, nul)
    return alt.reshape(N, W, S), nul.reshape(N, W, S)


def scores_pairs_packed(pidx, tables, tvecs, xts, lengths, starts,
                        codes_all, *, nseg):
    """B6 wrapper: score N (pack, window group) pairs of W slots, slot w's
    window against each of the pack's `nseg` profiles.  pidx (N,) indexes
    packs: tables (NPACK, 1364, 2 * Kp + 128) and tvecs (NPACK, 8, Kp)
    from ops/tables.py build_tables_packed; xts, lengths, starts and
    codes_all as for `scores_pairs`.  Returns (alt, null) (N, W, nseg)
    f32; pad slots and empty segments +inf.  Segment s of every slot
    equals `scores_pairs` on that window with profile s alone."""
    N, W = starts.shape
    Kp = _check_packed_tables(pidx, tables, tvecs, nseg, N)
    _check(xts, "xts", torch.float32, (N, W, 16))
    _check(lengths, "lengths", torch.int32, (N, W, 1))
    _check(starts, "starts", torch.int32, (N, W))
    _check(codes_all, "codes_all", torch.int32, (codes_all.shape[0], 5))
    args = (pidx, tables, tvecs, xts, lengths, starts, codes_all)
    if not on_cuda(*args):
        return scores_pairs_packed_plain(*args, nseg=nseg)
    alt = torch.empty((N, W, nseg), dtype=torch.float32,
                      device=tables.device)
    nul = torch.empty_like(alt)
    _launch_shaped("dtt_score_packed", "packed", Kp, packed_shape(Kp, nseg),
                   *args, alt, nul, N, W, nseg, Kp, codes_all.shape[0])
    return alt, nul


def scores_pairs_packed_chained_plain(pidx, tables, tvecs, run_sblk,
                                      run_len, run_gstart, win_sblk,
                                      win_len, win_xti, xt_lut, codes_all,
                                      *, nseg):
    """Plain PyTorch B7 (see `scores_pairs_packed_chained`), in chain
    coordinates as `_chain_expand` and `_iseg_window_expand` lay it out:
    each (pair, slot) row runs positions l = 1.. of its chain; the code
    rows of a block come from the first run that covers it (run 0's first
    block where none does); at the first block of a segment's entry that
    segment is reseeded, its xtrans row follows the entry that covers the
    block, and T/R latch at the entry's chain-coordinate end
    sblk * KAPPA + len.  Returns (alt, null) (N, W, nseg, C) f32; pad
    entries +inf."""
    N, W, CR = run_len.shape
    S, C = nseg, win_len.shape[3]
    P, R, Wt = tables.shape
    Kp, B = tvecs.shape[2], N * W
    T = codes_all.shape[0]
    dev = tables.device
    flat = tables.reshape(P * R, Wt)
    base = (pidx.long() * R).repeat_interleave(W)
    tv = tvecs[pidx.long()].repeat_interleave(W, dim=0)
    rs, rl, rg = (a.reshape(B, CR).long() for a in
                  (run_sblk, run_len, run_gstart))
    r_end = rs + (rl + KAPPA - 1) // KAPPA
    ws, wl, wx = (a.reshape(B, S, C).long() for a in
                  (win_sblk, win_len, win_xti))
    real = wl > 0
    end_blk = ws + (wl + KAPPA - 1) // KAPPA
    end = torch.where(real, ws * KAPPA + wl, 0)
    alt = torch.full((B, S, C), INF, device=dev)
    nul = torch.full((B, S, C), INF, device=dev)
    dp = _PackedPendingDP(B, Kp, S, dev)
    ends = set(end[real].tolist())  # read once: the loop never waits
    rowi = torch.arange(B, device=dev)
    for l in range(1, max(ends, default=0) + 1):
        if (l - 1) % KAPPA == 0:  # a new block
            b = (l - 1) // KAPPA
            rcov = (rl > 0) & (rs <= b) & (b < r_end)
            rc = rcov.int().argmax(1)  # first covering run
            off = torch.where(rcov.any(1),
                              rg[rowi, rc] + (b - rs[rowi, rc]) * KAPPA,
                              rg[:, 0]) - (l - 1)
            cov = real & (ws <= b) & (b < end_blk)
            active = cov.any(2)
            ci = cov.int().argmax(2)[:, :, None]  # entries are disjoint
            xt = xt_lut[torch.where(active, wx.gather(2, ci)[:, :, 0], 0)]
            dp.reseed(active & (ws.gather(2, ci)[:, :, 0] == b), xt)
        crow = (off + (l - 1)).clamp(0, T - 1)
        Tl, Rl = dp.step(_emission_rows(flat, base, codes_all, crow), tv, xt)
        if l in ends:
            hit = end == l
            alt = torch.where(hit, Tl[:, :, None], alt)
            nul = torch.where(hit, Rl[:, :, None], nul)
    return alt.reshape(N, W, S, C), nul.reshape(N, W, S, C)


def scores_pairs_packed_chained(pidx, tables, tvecs, run_sblk, run_len,
                                run_gstart, win_sblk, win_len, win_xti,
                                xt_lut, codes_all, *, nseg):
    """B7 wrapper: score N (pack, slot group) pairs of W slots.  Each slot
    carries one shared code stream, a chain of up to CR read runs: run
    (n, w, r) holds run_len nt (0 = pad) whose codes start at row
    run_gstart of `codes_all`, placed at block run_sblk of the slot's
    chain (KAPPA-position blocks).  Each segment s lays its own window
    list over that chain: entry (n, w, s, c) is a window of win_len nt
    (0 = pad) starting at chain block win_sblk, with xtrans row
    xt_lut[win_xti].  Contract (the reference's): runs are disjoint in
    blocks, the entries of one (slot, segment) are disjoint and in block
    order, and every block of a real entry is covered by a run.  Whole-read
    windows are the case where every segment lists the slot's runs as its
    windows.  Returns (alt, null) (N, W, nseg, C) f32; pad entries +inf.
    Every real entry equals that window scored by `scores_pairs_packed`.
    The kernel scores each entry from its own reseed."""
    N, W, CR = run_len.shape
    Kp = _check_packed_tables(pidx, tables, tvecs, nseg, N)
    if win_len.dim() != 4:
        raise ValueError(f"win_len: shape {tuple(win_len.shape)}, expected "
                         "(N, W, nseg, C)")
    C = win_len.shape[3]
    for name, a in (("run_sblk", run_sblk), ("run_len", run_len),
                    ("run_gstart", run_gstart)):
        _check(a, name, torch.int32, (N, W, CR))
    for name, a in (("win_sblk", win_sblk), ("win_len", win_len),
                    ("win_xti", win_xti)):
        _check(a, name, torch.int32, (N, W, nseg, C))
    _check(xt_lut, "xt_lut", torch.float32, (xt_lut.shape[0], 16))
    _check(codes_all, "codes_all", torch.int32, (codes_all.shape[0], 5))
    if CR < 1:
        raise ValueError("a slot needs at least one code run")
    args = (pidx, tables, tvecs, run_sblk, run_len, run_gstart, win_sblk,
            win_len, win_xti, xt_lut, codes_all)
    if not on_cuda(*args):
        return scores_pairs_packed_chained_plain(*args, nseg=nseg)
    alt = torch.empty((N, W, nseg, C), dtype=torch.float32,
                      device=tables.device)
    nul = torch.empty_like(alt)
    _launch_shaped("dtt_score_packed_chained", "pchain", Kp,
                   packed_shape(Kp, nseg), *args, alt, nul, N, W, nseg, C,
                   CR, Kp, codes_all.shape[0])
    return alt, nul


# ---------------------------------------------------------------------------
# B2: phase-2 trellis
# ---------------------------------------------------------------------------


def _consider(best, code, cand, c):
    take = cand < best
    return torch.minimum(best, cand), torch.where(take, c, code)


def _first_min(cands, codes):
    """Sequential `_consider` over candidates stacked in order on dim 0,
    from an initial +inf whose code is codes[0] (cands[0] must be that
    +inf): the minimum and the code of its first occurrence (torch.min
    returns the first index of a tied minimum)."""
    best, first = cands.min(0)
    return best, codes[first]


def paths_pairs_plain(pidx, tables, tvecs, xts, lengths, starts, codes_all,
                      *, nlb):
    """Plain PyTorch B2: the pull form of `_kernel_path`, one Python step
    per DP position over (N*W, Kp) planes, same candidate order and f32
    sums, Lk = nlb * PATH_KAPPA rows per window (positions past Lk are not
    run).  Each state's candidates are stacked in the kernel's order and
    the first minimum wins, as the kernel's strict `<` takes it.  Returns
    (xnode (N, W, Lk), node (N, W, Lk, Kp)) int32; rows at or past the
    batch's longest window are 0."""
    N, W = starts.shape
    Kp = tables.shape[2]
    B = N * W
    Lk = nlb * PATH_KAPPA
    flat, base, tv, xt, lens, st = _rows_setup(pidx, tables, tvecs, xts,
                                               lengths, starts)
    T = codes_all.shape[0]
    dev = tables.device
    i32 = torch.int32
    xn = torch.zeros((B, Lk), dtype=i32, device=dev)
    nd = torch.zeros((B, Lk, Kp), dtype=i32, device=dev)
    Mr = torch.full((5, B, Kp), INF, device=dev)
    Ir, Dr = Mr.clone(), Mr.clone()
    SML = torch.full((7, 5, B), INF, device=dev)  # S B N J C E R rings
    SML[0, 0] = 0.0
    SML[1, 0] = xt[:, XT_SB]
    lane = torch.arange(Kp, device=dev)[None, :]
    big = torch.tensor(1 << 30, dtype=torch.long, device=dev)

    def x(j):
        return xt[:, j]

    def tx(j):  # xtrans column j against (5, B) planes
        return xt[None, :, j]

    # candidate codes in the kernel's order: t = 5 .. 1 (c = t - 1), and
    # per t the sources B M I D (M), I M (I), S|E N|J|C (N, J, C); entry
    # 0 is the initial +inf
    cs = [t - 1 for t in range(5, 0, -1)]

    def code_lut(first, per_t):
        return torch.tensor([first] + [o + c for c in cs for o in per_t],
                            dtype=i32, device=dev)

    m_codes = code_lut(4, (0, 5, 10, 15))
    i_codes = code_lut(9, (5, 0))
    s_codes = code_lut(4, (0, 5))
    inf_m = torch.full((1, B, Kp), INF, device=dev)
    inf_b = torch.full((1, B), INF, device=dev)
    t_col = torch.arange(4, -1, -1, device=dev)  # t - 1 for t = 5 .. 1

    def pick(codes, lead, *cands):
        # per-t candidates (5, ...) each -> one stack in the kernel's order
        per_t = torch.stack(cands, 1).flatten(0, 1)
        return _first_min(torch.cat([lead, per_t]), codes)

    maxlen = min(int(lens.max()) if B else 0, Lk)
    for l in range(1, maxlen + 1):
        # (5, B, Kp) rows of the fragments ENDING at l, t = 5 .. 1
        crow = (st[None, :] + (l - 1 - t_col)[:, None]).clamp(0, T - 1)
        ma = flat[base[None, :] + codes_all[crow, t_col[:, None]].long()]
        nil = ma[:, :, Kp - 2]
        bg = ma[:, :, Kp - 1:Kp]
        ring = [(l - t + 10) % 5 for t in range(5, 0, -1)]
        M_, I_, D_ = Mr[ring], Ir[ring], Dr[ring]
        Sr, Br, Nr, Jr, Cr, Er = (SML[j][ring] for j in range(6))

        M, bm_code = pick(m_codes, inf_m,
                          (Br[:, :, None] + tv[:, TV_BM]) + ma,
                          torch.roll(M_ + tv[:, TV_MMS], 1, -1) + ma,
                          torch.roll(I_ + tv[:, TV_IMS], 1, -1) + ma,
                          torch.roll(D_ + tv[:, TV_DMS], 1, -1) + ma)
        I, bi_code = pick(i_codes, inf_m, (I_ + tv[:, TV_II]) + bg,
                          (M_ + tv[:, TV_MI]) + bg)
        best_n, n_code = pick(s_codes, inf_b, (Sr + tx(XT_SN)) + nil,
                              (Nr + tx(XT_NN)) + nil)
        best_j, j_code = pick(s_codes, inf_b, (Er + tx(XT_EJ)) + nil,
                              (Jr + tx(XT_JJ)) + nil)
        best_c, c_code = pick(s_codes, inf_b, (Er + tx(XT_EC)) + nil,
                              (Cr + tx(XT_CC)) + nil)

        A = torch.roll(M, 1, -1) + tv[:, TV_MD]
        D = (torch.cummin(A - tv[:, TV_DDCUM], dim=-1).values
             + tv[:, TV_DDCUM])
        d_is_dd = (D < A).to(i32)

        vals = torch.minimum(M, D)
        rowmin = vals.amin(-1, keepdim=True)
        k_first = torch.where(vals == rowmin, lane, big).amin(-1,
                                                              keepdim=True)
        m_at_k = ((lane == k_first) & (M == rowmin)).any(-1).to(i32)
        e_field = 2 * k_first[:, 0].to(i32) + (1 - m_at_k)
        E = rowmin[:, 0]

        Bl = torch.full((B,), INF, device=dev)
        b_field = torch.ones((B,), dtype=i32, device=dev)
        for ci, cand in enumerate((best_n + x(XT_NB), E + x(XT_EB),
                                   best_j + x(XT_JB))):
            Bl, b_field = _consider(Bl, b_field, cand, ci + 1)
        Tl = torch.full((B,), INF, device=dev)
        t_field = torch.zeros((B,), dtype=i32, device=dev)
        for ci, cand in enumerate((E + x(XT_ET), best_c + x(XT_CT))):
            Tl, t_field = _consider(Tl, t_field, cand, ci)

        xn[:, l - 1] = (n_code | (b_field << 4) | (e_field << 6)
                        | (c_code << 21) | (t_field << 25) | (j_code << 26))
        nd[:, l - 1] = bm_code | (d_is_dd << 5) | (bi_code << 6)

        slot = l % 5
        Mr[slot], Ir[slot], Dr[slot] = M, I, D
        for j, v in enumerate((torch.full((B,), INF, device=dev), Bl,
                               best_n, best_j, best_c, E)):
            SML[j, slot] = v
    return xn.reshape(N, W, Lk), nd.reshape(N, W, Lk, Kp)


def paths_pairs(pidx, tables, tvecs, xts, lengths, starts, codes_all, *,
                nlb):
    """B2 wrapper: (xnode (N, W, Lk), node (N, W, Lk, Kp)) int32 with
    Lk = nlb * PATH_KAPPA; row l-1 holds DP position l, rows at or past a
    window's length are undefined on the card (never read by the walk).
    Lane planes up to MAX_LARGE_KP: the large-K tier's survivors take it
    too."""
    N, W, Kp = _check_inputs(pidx, tables, tvecs, xts, lengths, starts,
                             codes_all, max_kp=MAX_LARGE_KP)
    if not on_cuda(pidx, tables, tvecs, xts, lengths, starts, codes_all):
        return paths_pairs_plain(pidx, tables, tvecs, xts, lengths, starts,
                                 codes_all, nlb=nlb)
    Lk = nlb * PATH_KAPPA
    dev = tables.device
    xn = torch.empty((N, W, Lk), dtype=torch.int32, device=dev)
    nd = torch.empty((N, W, Lk, Kp), dtype=torch.int32, device=dev)
    _launch_shaped("dtt_path_pairs", "path", Kp, cluster_shape(Kp, "path"),
                   pidx, tables, tvecs, xts, lengths, starts, codes_all, xn,
                   nd, N, W, Kp, codes_all.shape[0], Lk)
    return xn, nd


# ---------------------------------------------------------------------------
# B9: dense-grid scores, every profile against every window
# ---------------------------------------------------------------------------


def _check_grid(tables, tvecs, xts, lengths, starts, codes_all):
    B = starts.shape[0]
    P, _, Kp = tables.shape
    _check(tables, "tables", torch.float32, (P, TABLE_SIZE, Kp))
    _check(tvecs, "tvecs", torch.float32, (P, 8, Kp))
    _check(xts, "xts", torch.float32, (B, 16))
    _check(lengths, "lengths", torch.int32, (B,))
    _check(starts, "starts", torch.int32, (B,))
    _check(codes_all, "codes_all", torch.int32, (codes_all.shape[0], 5))
    if codes_all.shape[0] == 0:
        raise ValueError("codes_all: no rows")
    _check_kp(Kp, MAX_LARGE_KP)
    return P, B, Kp


def scores_grid_plain(tables, tvecs, xts, lengths, starts, codes_all):
    """Plain PyTorch B9: the pull form of `_kernel`, one Python step per DP
    position over (P * B, Kp) planes, in the kernel's f32 operation order:
    the five ring slots read, then min(shift1(min(M+MMs, I+IMs, D+DMs)),
    B+BM) + ma, min(I+II, M+MI) + bg, min(S+SN, N+NN) + nil and
    min_t(R + nil) + RR, T and R captured where l == length.  The
    END-indexed row of position l and duration t is codes_all[clamp(starts
    + l - t, 0, T - 1), t - 1], as B2 reads it.  Returns (alt, null) (P, B)
    f32; windows of length 0 +inf."""
    P, B = tables.shape[0], starts.shape[0]
    Kp = tables.shape[2]
    R = P * B
    dev = tables.device
    flat = tables.reshape(P * TABLE_SIZE, Kp)
    prof = torch.arange(P, device=dev).repeat_interleave(B)
    win = torch.arange(B, device=dev).repeat(P)
    base = prof * TABLE_SIZE
    tv = tvecs[prof]  # (R, 8, Kp)
    xt = xts[win]  # (R, 16)
    lens = lengths.long()[win]
    st = starts.long()[win]
    T = codes_all.shape[0]
    M = torch.full((5, R, Kp), INF, device=dev)  # rings, slot = l % 5
    I, D = M.clone(), M.clone()
    SML = torch.full((7, 5, R), INF, device=dev)  # S B N J C E R rings
    SML[0, 0] = 0.0
    SML[1, 0] = xt[:, XT_SB]
    SML[6, 0] = -xt[:, XT_RR]
    Tfin = torch.full((R,), INF, device=dev)
    Rfin = Tfin.clone()
    inf_r = Tfin.clone()
    t1 = torch.arange(1, 6, device=dev)  # duration t, row t - 1

    def x(j):
        return xt[:, j]

    maxlen = int(lens.max()) if R else 0
    for l in range(1, maxlen + 1):
        ring = [(l - t) % 5 for t in range(1, 6)]  # slot of position l - t
        crow = (st[None, :] + (l - t1)[:, None]).clamp(0, T - 1)  # (5, R)
        ma = flat[base[None, :] + codes_all[crow, (t1 - 1)[:, None]].long()]
        nil = ma[:, :, Kp - 2]  # (5, R)
        bg = ma[:, :, Kp - 1:Kp]
        Mr, Ir, Dr = M[ring], I[ring], D[ring]  # (5, R, Kp)
        Sr, Br, Nr, Jr, Cr, Er, Rr = SML[:, ring]  # (5, R) each

        inner = torch.minimum(torch.minimum(Mr + tv[:, TV_MMS],
                                            Ir + tv[:, TV_IMS]),
                              Dr + tv[:, TV_DMS])
        shifted = torch.roll(inner, 1, -1)  # the wrap lane is +inf
        bcand = Br[:, :, None] + tv[:, TV_BM]
        M_l = (torch.minimum(shifted, bcand) + ma).amin(0)
        icand = torch.minimum(Ir + tv[:, TV_II], Mr + tv[:, TV_MI])
        I_l = (icand + bg).amin(0)
        A = torch.roll(M_l, 1, -1) + tv[:, TV_MD]
        D_l = (torch.cummin(A - tv[:, TV_DDCUM], dim=-1).values
               + tv[:, TV_DDCUM])
        E_l = torch.minimum(M_l.amin(-1), D_l.amin(-1))
        N_l = (torch.minimum(Sr + x(XT_SN), Nr + x(XT_NN)) + nil).amin(0)
        J_l = (torch.minimum(Er + x(XT_EJ), Jr + x(XT_JJ)) + nil).amin(0)
        C_l = (torch.minimum(Er + x(XT_EC), Cr + x(XT_CC)) + nil).amin(0)
        B_l = torch.minimum(torch.minimum(N_l + x(XT_NB), E_l + x(XT_EB)),
                            J_l + x(XT_JB))
        T_l = torch.minimum(E_l + x(XT_ET), C_l + x(XT_CT))
        R_l = (Rr + nil).amin(0) + x(XT_RR)

        at_end = lens == l
        Tfin = torch.where(at_end, T_l, Tfin)
        Rfin = torch.where(at_end, R_l, Rfin)
        slot = l % 5
        M[slot], I[slot], D[slot] = M_l, I_l, D_l
        SML[:, slot] = torch.stack([inf_r, B_l, N_l, J_l, C_l, E_l, R_l])
    return Tfin.reshape(P, B), Rfin.reshape(P, B)


def scores_grid(tables, tvecs, xts, lengths, starts, codes_all):
    """B9 wrapper: (alt, null) (P, B) f32 min-plus costs of every profile
    of `tables` (P, 1364, Kp) against every window b of xts (B, 16),
    lengths (B,) int32 (0 = pad, +inf out) and starts (B,) int32 into the
    START-indexed code table codes_all (T, 5).  Lane planes up to
    MAX_LARGE_KP.  On the card a (profile, window) pair runs the score
    body of B1 and B4 in B4's launch shape, `cluster_shape(Kp)`: one CTA
    up to Kp 2048, a thread-block cluster past it, its DP state in shared
    memory at any Kp."""
    P, B, Kp = _check_grid(tables, tvecs, xts, lengths, starts, codes_all)
    if not on_cuda(tables, tvecs, xts, lengths, starts, codes_all):
        return scores_grid_plain(tables, tvecs, xts, lengths, starts,
                                 codes_all)
    alt = torch.empty((P, B), dtype=torch.float32, device=tables.device)
    nul = torch.empty_like(alt)
    # the profile is the grid's y index: one launch per GRID_MAX_P profiles
    for lo, hi in grid_chunks(P, GRID_MAX_P):
        _launch_shaped("dtt_score_grid", "grid", Kp, cluster_shape(Kp),
                       *(_rows(t, lo, hi) for t in (tables, tvecs)), xts,
                       lengths, starts, codes_all,
                       *(_rows(t, lo, hi) for t in (alt, nul)), hi - lo, B,
                       Kp, codes_all.shape[0])
    return alt, nul


def grid_chunks(P: int, max_p: int) -> list[tuple[int, int]]:
    """[lo, hi) profile ranges of B9's launches, in order: P profiles in
    chunks of at most max_p (gridDim.y, 65535 on the card)."""
    return [(lo, min(lo + max_p, P)) for lo in range(0, P, max_p)]


def _rows(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of t (contiguous), t itself when that is all of it."""
    return t if (lo, hi) == (0, t.shape[0]) else t[lo:hi]


class GridScanEngine:
    """Profile tables on one device; scores dense (P, B) tiles with B9.

    Counterpart of PallasScanEngine (viterbi_pallas.py:1663-1688): the
    tables and transition vectors of every profile at their common Kp,
    built once.  `scores` takes a host window batch as the reference's
    engines do.  On a CUDA device every call launches B9 (no gather-mode
    switch: the reference's slot/tregs/static layouts, PREFETCH and the
    host code relayouts are TPU layouts of one computation); on the CPU it
    runs the plain version."""

    def __init__(self, costs_list, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"GridScanEngine(device={device!r}) but no "
                               "CUDA device is available")
        Kp = common_kp(costs_list)
        _check_kp(Kp, MAX_LARGE_KP)
        tables, tvecs = stack_tables(costs_list, Kp)
        self.tables = tables.to(self.device)
        self.tvecs = tvecs.to(self.device)

    def grid_inputs(self, xt, codes, lengths):
        """A host batch -> B9's inputs on the device: xts (B, 16),
        lengths (B,), starts (B,) and codes_all (B * Lpad, 5).  xt (B, 13)
        f32, codes (B, Lpad, 5) int32 END-indexed, lengths (B,).  Window b
        owns rows [b * Lpad, (b + 1) * Lpad) of codes_all, its codes
        START-indexed there (start_codes): row b * Lpad + i, column t - 1
        is the fragment of length t starting at position i + 1."""
        c = torch.as_tensor(np.asarray(codes, np.int32))
        B, Lpad = c.shape[0], c.shape[1]
        xts = torch.zeros((B, 16), dtype=torch.float32)
        xts[:, :13] = torch.as_tensor(np.asarray(xt, np.float32))
        lens = torch.as_tensor(np.asarray(lengths, np.int32))
        sc = torch.zeros_like(c)
        for t0 in range(5):
            n = max(0, Lpad - t0)
            sc[:, :n, t0] = c[:, t0:t0 + n, t0]
        codes_all = sc.reshape(B * Lpad, 5)
        if codes_all.shape[0] == 0:
            codes_all = torch.zeros((1, 5), dtype=torch.int32)
        starts = torch.arange(B, dtype=torch.int32) * Lpad
        return [t.to(self.device) for t in (xts, lens, starts, codes_all)]

    def scores(self, xt, codes, lengths):
        """Returns (null_costs, alt_costs): (P, B) f32 numpy arrays."""
        alt, nul = scores_grid(self.tables, self.tvecs,
                               *self.grid_inputs(xt, codes, lengths))
        return nul.cpu().numpy(), alt.cpu().numpy()
