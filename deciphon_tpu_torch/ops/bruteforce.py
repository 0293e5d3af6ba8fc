"""Exhaustive path enumeration over the frame-profile state graph.

An *independent* oracle for tiny models: enumerates every legal state path
(recursively, no dynamic programming) and returns the minimum total cost.
Used to validate the vectorized Viterbi engines' recurrence, ring buffers,
masking and code lookups on small (K <= 3, L <= 8) cases.

The move set mirrors the kernel's transition semantics exactly
(c-core/viterbi.c:492-586 + protein_setup_viterbi's cost loading):
pre-combined special costs (EB = EJ+JB etc.), free exits M_k/D_k -> E.
"""

from __future__ import annotations

import numpy as np

from ..xtrans import (XT_CC, XT_CT, XT_EB, XT_EC, XT_EJ, XT_ET, XT_JB, XT_JJ,
                      XT_NB, XT_NN, XT_RR, XT_SB, XT_SN)
from .costs import (CT_BM, CT_DD, CT_DM, CT_II, CT_IM, CT_MD, CT_MI, CT_MM,
                    ViterbiCosts)


def _code(seq, pos, t):
    from ..frame import FRAG_OFFSETS

    c = FRAG_OFFSETS[t - 1]
    m = 1
    for s in reversed(seq[pos : pos + t]):
        c += int(s) * m
        m *= 4
    return c


def best_path_cost(costs: ViterbiCosts, seq: np.ndarray) -> float:
    """Minimum T-cost over all complete paths (float64 accumulation).

    seq: int8 array of nucleotide indices (the window).
    """
    L = len(seq)
    K = costs.K
    xt = costs.xt.astype(np.float64)
    core = costs.core.astype(np.float64)
    match = costs.match.astype(np.float64)
    null = costs.null.astype(np.float64)
    bg = costs.background.astype(np.float64)

    def emit_codes(pos):
        out = []
        for t in range(1, 6):
            if pos + t <= L:
                out.append((t, _code(seq, pos, t)))
        return out

    from functools import lru_cache

    @lru_cache(maxsize=None)
    def rest(state, k, pos):
        """Min cost to complete the path from (state, pos) to T at L.

        A memoized suffix recursion — deliberately scalar, float64, and
        structured differently from the vectorized engines.
        """
        if state == "T":
            return 0.0 if pos == L else np.inf
        out = np.inf
        if state == "S":
            for t, c in emit_codes(pos):
                out = min(out, xt[XT_SN] + null[c] + rest("N", -1, pos + t))
            out = min(out, xt[XT_SB] + rest("B", -1, pos))
        elif state == "N":
            for t, c in emit_codes(pos):
                out = min(out, xt[XT_NN] + null[c] + rest("N", -1, pos + t))
            out = min(out, xt[XT_NB] + rest("B", -1, pos))
        elif state == "B":
            for kk in range(K):
                for t, c in emit_codes(pos):
                    out = min(out, core[CT_BM, kk] + match[c, kk]
                              + rest("M", kk, pos + t))
        elif state == "M":
            if k + 1 < K:
                for t, c in emit_codes(pos):
                    out = min(out, core[CT_MM, k + 1] + match[c, k + 1]
                              + rest("M", k + 1, pos + t))
                out = min(out, core[CT_MD, k + 1] + rest("D", k + 1, pos))
            for t, c in emit_codes(pos):
                out = min(out, core[CT_MI, k] + bg[c] + rest("I", k, pos + t))
            out = min(out, rest("E", -1, pos))
        elif state == "I":
            if k + 1 < K:
                for t, c in emit_codes(pos):
                    out = min(out, core[CT_IM, k + 1] + match[c, k + 1]
                              + rest("M", k + 1, pos + t))
            for t, c in emit_codes(pos):
                out = min(out, core[CT_II, k] + bg[c] + rest("I", k, pos + t))
        elif state == "D":
            if k + 1 < K:
                for t, c in emit_codes(pos):
                    out = min(out, core[CT_DM, k + 1] + match[c, k + 1]
                              + rest("M", k + 1, pos + t))
                out = min(out, core[CT_DD, k + 1] + rest("D", k + 1, pos))
            out = min(out, rest("E", -1, pos))
        elif state == "E":
            for t, c in emit_codes(pos):
                out = min(out, xt[XT_EJ] + null[c] + rest("J", -1, pos + t))
                out = min(out, xt[XT_EC] + null[c] + rest("C", -1, pos + t))
            out = min(out, xt[XT_EB] + rest("B", -1, pos))
            out = min(out, xt[XT_ET] + rest("T", -1, pos))
        elif state == "J":
            for t, c in emit_codes(pos):
                out = min(out, xt[XT_JJ] + null[c] + rest("J", -1, pos + t))
            out = min(out, xt[XT_JB] + rest("B", -1, pos))
        elif state == "C":
            for t, c in emit_codes(pos):
                out = min(out, xt[XT_CC] + null[c] + rest("C", -1, pos + t))
            out = min(out, xt[XT_CT] + rest("T", -1, pos))
        else:
            raise AssertionError(state)
        return out

    return rest("S", -1, 0)


def best_null_cost(costs: ViterbiCosts, seq: np.ndarray) -> float:
    """Null-model minimum cost by enumeration (viterbi.c:696-719 semantics:
    initial R gets -RR so each of n fragments nets (n-1) RR charges)."""
    L = len(seq)
    xt = costs.xt.astype(np.float64)
    null = costs.null.astype(np.float64)
    RR = xt[XT_RR]
    best = [np.inf]

    def walk(pos, acc):
        if pos == L:
            best[0] = min(best[0], acc)
            return
        for t in range(1, 6):
            if pos + t <= L:
                c = _code(seq, pos, t)
                walk(pos + t, acc + RR + null[c])

    walk(0, -RR)
    return best[0]
