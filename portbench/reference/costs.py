"""Min-plus cost layout for the frame Viterbi engines.

Parity: c-core/protein.c:353-394 (protein_setup_viterbi) — all scores are
negated log-probs; transition vectors are laid out per *destination* node
with boundary clamping:

  BM[k] = -BMk[k]                          k = 0..K-1
  MM[k] = -trans[k].MM   (k>=1), INF at 0
  MD[k] = -trans[k].MD   (k>=1), INF at 0
  IM[k] = -trans[k].IM   (k>=1), INF at 0
  DM[k] = -trans[k].DM   (k>=1), INF at 0
  DD[k] = -trans[k].DD   (k>=1), INF at 0
  MI[k] = -trans[k+1].MI (k<=K-2), INF at K-1
  II[k] = -trans[k+1].II (k<=K-2), INF at K-1

The benchmark's frozen copy of the arithmetic of
deciphon_tpu/ops/costs.py (and of deciphon_tpu_torch's copy of it); the reference never
imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .press import FrameProfile
from .xtrans import xtrans_cost_vector

INF = np.float32(np.inf)
NUM_TRANS_VECS = 9  # BM MM MI MD IM II DM DD DDCUM
CT_BM, CT_MM, CT_MI, CT_MD, CT_IM, CT_II, CT_DM, CT_DD = range(8)
# Canonical saturated DD cumulative sum (float64 cumsum cast to f32),
# row 8: the delete-chain prefix-scan offset.  Computed ONCE host-side so
# every engine (lax.scan oracle, score kernel, path kernel) uses
# bit-identical values — an in-trace f32 cumsum rounds differently and
# flips D-backpointer ties between engines.
CT_DDCUM = 8
DD_SAT = 1e30  # saturation for +inf DD entries (padding lanes)


def dd_cum_row(dd: np.ndarray) -> np.ndarray:
    """Saturated float64 cumsum of a DD cost row, cast to f32."""
    ddc = np.zeros(len(dd), np.float64)
    ddc[1:] = np.minimum(dd[1:].astype(np.float64), DD_SAT)
    return np.cumsum(ddc, dtype=np.float64).astype(np.float32)


@dataclass
class ViterbiCosts:
    """Everything one Viterbi run needs, as dense f32 cost arrays."""

    K: int
    # (8, K) core transition costs, row order BM MM MI MD IM II DM DD
    core: np.ndarray
    # (1364, K) match emission costs (match[c, k] = cost of fragment c at node k)
    match: np.ndarray
    # (1364,) null and background emission costs
    null: np.ndarray
    background: np.ndarray
    # (13,) special transition costs (order: xtrans.xtrans_cost_vector)
    xt: np.ndarray

def build_costs(p: FrameProfile, multi_hits: bool = True,
                hmmer3_compat: bool = False, window_len: int = 1) -> ViterbiCosts:
    K = p.core_size
    t = p.trans  # (K+1, 7) log-probs, col order MM MI MD IM II DM DD
    core = np.full((NUM_TRANS_VECS, K), INF, dtype=np.float32)
    core[CT_BM] = -p.BMk
    core[CT_MM, 1:] = -t[1:K, 0]
    core[CT_MI, : K - 1] = -t[1:K, 1]
    core[CT_MD, 1:] = -t[1:K, 2]
    core[CT_IM, 1:] = -t[1:K, 3]
    core[CT_II, : K - 1] = -t[1:K, 4]
    core[CT_DM, 1:] = -t[1:K, 5]
    core[CT_DD, 1:] = -t[1:K, 6]
    core[CT_DDCUM] = dd_cum_row(core[CT_DD])

    return ViterbiCosts(
        K=K,
        core=core,
        match=(-p.match_emission[:K]).T.copy(),  # (1364, K)
        null=(-p.null_emission).astype(np.float32),
        background=(-p.bg_emission).astype(np.float32),
        xt=xtrans_cost_vector(multi_hits, hmmer3_compat, window_len),
    )
