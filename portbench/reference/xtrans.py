"""Length-conditioned special-state transitions (HMMER3-style algnull model).

Parity: c-core/xtrans.c:21-51 (xtrans_setup) and :53-68
(xtrans_setup_viterbi's combined-cost mapping).

The scan engine re-derives these per window with L = max(window_len/3, 1)
(c-core/thread.c:113 work_reset(work, max(L/3, 1))).

The benchmark's frozen copy of the arithmetic of
deciphon_tpu/xtrans.py (and of deciphon_tpu_torch's copy of it); the reference never
imports the program.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class XTrans:
    """Special transitions as log-probs (reference xtrans struct)."""

    NN: float
    NB: float
    EC: float
    CC: float
    CT: float
    EJ: float
    JJ: float
    JB: float
    RR: float


def xtrans_setup(multi_hits: bool, hmmer3_compat: bool, seq_size: int) -> XTrans:
    if seq_size <= 0:
        raise ValueError("seq_size must be positive")
    L = float(seq_size)

    if multi_hits:
        q = 0.5
        log_q = math.log(0.5)
    else:
        q = 0.0
        log_q = -math.inf

    lp = math.log(L) - math.log(L + 2 + q / (1 - q))
    l1p = math.log(2 + q / (1 - q)) - math.log(L + 2 + q / (1 - q))
    lr = math.log(L) - math.log(L + 1)

    NN = CC = JJ = lp
    if hmmer3_compat:
        NN = CC = JJ = 0.0

    return XTrans(
        NN=NN, NB=l1p, EC=math.log(1 - q), CC=CC, CT=l1p,
        EJ=log_q, JJ=JJ, JB=l1p, RR=lr,
    )


def xtrans_costs(x: XTrans) -> dict[str, np.float32]:
    """Negated, pre-combined costs as loaded into the kernel.

    Parity: c-core/xtrans.c:53-68 — note EB/ET fold the mute hop through
    J / C respectively, and SN/SB charge the N/B arrival like NN/NB.
    """
    f = np.float32
    return {
        "RR": f(-x.RR),
        "SN": f(-x.NN),
        "NN": f(-x.NN),
        "SB": f(-x.NB),
        "NB": f(-x.NB),
        "EB": f(-(x.EJ + x.JB)),
        "JB": f(-x.JB),
        "EJ": f(-(x.EJ + x.JJ)),
        "JJ": f(-x.JJ),
        "EC": f(-(x.EC + x.CC)),
        "CC": f(-x.CC),
        "ET": f(-(x.EC + x.CT)),
        "CT": f(-x.CT),
    }


@functools.lru_cache(maxsize=65536)
def xtrans_cost_vector(multi_hits: bool, hmmer3_compat: bool,
                       window_len: int) -> np.ndarray:
    """(13,) f32 cost vector in the fixed order used by the Viterbi kernels.

    Order: RR SN NN SB NB EB JB EJ JJ EC CC ET CT.
    window_len is in nucleotides; the xtrans length is max(window_len//3, 1)
    (c-core/thread.c:113).

    Memoized: the scan recomputes this once per (profile, window) pair and
    window lengths repeat heavily (full windows are exactly min(50K, 100k)
    nt per profile), so the cache turns a measured steady-state host cost
    into a dict hit.  The returned array is frozen against mutation.
    """
    x = xtrans_setup(multi_hits, hmmer3_compat, max(window_len // 3, 1))
    c = xtrans_costs(x)
    order = ["RR", "SN", "NN", "SB", "NB", "EB", "JB", "EJ", "JJ", "EC", "CC", "ET", "CT"]
    out = np.array([c[k] for k in order], dtype=np.float32)
    out.flags.writeable = False
    return out


XT_RR, XT_SN, XT_NN, XT_SB, XT_NB, XT_EB, XT_JB, XT_EJ, XT_JJ, XT_EC, XT_CC, XT_ET, XT_CT = range(13)
