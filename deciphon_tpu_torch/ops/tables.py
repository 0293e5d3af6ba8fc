"""Kernel parameter tables: profile costs as the kernels' lane layout.

Counterpart of deciphon_tpu/ops/viterbi_pallas.py (round_up, build_tables,
common_kp, packed_width, build_tables_packed).  The layout is the reference's exactly, so the tables compare
bit for bit and the CUDA kernels can be held against the Pallas kernels on
the same inputs:

  * Kp = round_up(K + 2, 128) lanes per profile;
  * emission table (1364, Kp) f32: lanes 0..K-1 match costs, lanes
    K..Kp-3 +inf pads, lane Kp-2 null costs, lane Kp-1 background costs;
  * transition vectors (8, Kp) f32, rows TV_*: source-indexed shifted
    MM/IM/DM, destination-indexed BM/MI/II/MD, and the saturated DD
    cumulative sum for the delete-chain prefix min.

Lane-packed tables (B6, B7) put NSEG profiles side by side on Kp = seg *
NSEG lanes, segment s on lanes [s * seg, (s + 1) * seg); the emission row
widens to 2 * Kp + PACK_PAD: match costs per segment | the owning segment's
background cost replicated over its lanes | the segments' null costs in
columns 2 * Kp + s; the DD cumulative sum restarts per segment.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame import TABLE_SIZE
from ..ops.costs import (CT_BM, CT_DD, CT_DM, CT_II, CT_IM,
                                    CT_MD, CT_MI, CT_MM, ViterbiCosts)

NEG_BIG = np.float32(1e30)  # DD saturation (ops/viterbi_jax.py)

# tvec row indices
TV_BM, TV_MMS, TV_MI, TV_MD, TV_IMS, TV_II, TV_DMS, TV_DDCUM = range(8)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_tables(costs: ViterbiCosts, Kp: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(table (1364, Kp) f32, tvec (8, Kp) f32) CPU tensors for one
    profile; Kp defaults to round_up(K + 2, 128)."""
    K = costs.K
    if Kp is None:
        Kp = round_up(K + 2, 128)
    if Kp < K + 2:
        raise ValueError(f"Kp={Kp} leaves no null/background lanes for K={K}")
    table = np.full((TABLE_SIZE, Kp), np.inf, np.float32)
    table[:, :K] = costs.match
    table[:, Kp - 2] = costs.null
    table[:, Kp - 1] = costs.background

    core = costs.core
    tvec = np.full((8, Kp), np.inf, np.float32)
    tvec[TV_BM, :K] = core[CT_BM]
    # source-indexed, shifted: MMs[k] = MM[k+1] (entering node k+1 from k)
    tvec[TV_MMS, : K - 1] = core[CT_MM, 1:]
    tvec[TV_IMS, : K - 1] = core[CT_IM, 1:]
    tvec[TV_DMS, : K - 1] = core[CT_DM, 1:]
    # destination-indexed
    tvec[TV_MI, :K] = core[CT_MI]
    tvec[TV_II, :K] = core[CT_II]
    tvec[TV_MD, :K] = core[CT_MD]
    # saturated DD cumulative sum (float64 cumsum, cast once)
    ddc = np.zeros(Kp, np.float32)
    ddc[1:K] = np.minimum(core[CT_DD, 1:K], NEG_BIG)
    ddc[K:] = NEG_BIG
    tvec[TV_DDCUM] = np.cumsum(ddc, dtype=np.float64).astype(np.float32)
    return torch.from_numpy(table), torch.from_numpy(tvec)


def common_kp(costs_list: list[ViterbiCosts]) -> int:
    return round_up(max(c.K for c in costs_list) + 2, 128)


def stack_tables(costs_list: list[ViterbiCosts], Kp: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, 1364, Kp) tables and (P, 8, Kp) tvecs at one common Kp."""
    Kp = common_kp(costs_list) if Kp is None else Kp
    pairs = [build_tables(c, Kp) for c in costs_list]
    return (torch.stack([t for t, _ in pairs]),
            torch.stack([v for _, v in pairs]))


PACK_PAD = 128  # pad after the per-segment null columns


def packed_width(Kp: int) -> int:
    """Row width of a packed emission table for a Kp-lane plane."""
    return 2 * Kp + PACK_PAD


def build_tables_packed(costs_list: list[ViterbiCosts], seg: int, nseg: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(table (1364, 2 * Kp + PACK_PAD) f32, tvec (8, Kp) f32) CPU tensors
    of one pack of at most `nseg` profiles, Kp = seg * nseg.  Missing
    trailing segments stay +inf everywhere and score +inf.  Each profile
    needs K + 1 <= seg: the +inf pad lane between two segments is what
    lets the kernels shift lanes without masking at the boundary."""
    if len(costs_list) > nseg:
        raise ValueError(f"{len(costs_list)} profiles for {nseg} segments")
    Kp = seg * nseg
    table = np.full((TABLE_SIZE, packed_width(Kp)), np.inf, np.float32)
    tvec = np.full((8, Kp), np.inf, np.float32)
    tvec[TV_DDCUM] = 0.0
    for s, costs in enumerate(costs_list):
        K = costs.K
        if K + 1 > seg:
            raise ValueError(f"K={K} leaves no pad lane in a {seg}-lane "
                             "segment")
        o = s * seg
        table[:, o:o + K] = costs.match
        table[:, Kp + o:Kp + o + seg] = costs.background[:, None]
        table[:, 2 * Kp + s] = costs.null
        core = costs.core
        tvec[TV_BM, o:o + K] = core[CT_BM]
        tvec[TV_MMS, o:o + K - 1] = core[CT_MM, 1:]
        tvec[TV_IMS, o:o + K - 1] = core[CT_IM, 1:]
        tvec[TV_DMS, o:o + K - 1] = core[CT_DM, 1:]
        tvec[TV_MI, o:o + K] = core[CT_MI]
        tvec[TV_II, o:o + K] = core[CT_II]
        tvec[TV_MD, o:o + K] = core[CT_MD]
        # the saturated DD cumulative sum restarts per segment, so its
        # values equal a single-profile build's bit for bit
        ddc = np.zeros(seg, np.float32)
        ddc[1:K] = np.minimum(core[CT_DD, 1:K], NEG_BIG)
        ddc[K:] = NEG_BIG
        tvec[TV_DDCUM, o:o + seg] = np.cumsum(
            ddc, dtype=np.float64).astype(np.float32)
    return torch.from_numpy(table), torch.from_numpy(tvec)


def stack_tables_packed(costs_list: list[ViterbiCosts], seg: int, nseg: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(NPACK, 1364, 2 * Kp + PACK_PAD) tables and (NPACK, 8, Kp) tvecs:
    pack i holds profiles [i * nseg, (i + 1) * nseg) of `costs_list`."""
    pairs = [build_tables_packed(costs_list[i:i + nseg], seg, nseg)
             for i in range(0, len(costs_list), nseg)]
    return (torch.stack([t for t, _ in pairs]),
            torch.stack([v for _, v in pairs]))
