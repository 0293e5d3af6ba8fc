"""The ε-frame (quasi-codon) emission model — the mathematical core.

Re-derivation of the imm library's frame-state emission distribution used by
the reference (c-core/model.c:267-281 `imm_frame_state_init(ε, span 1..5)`,
c-core/protein.c:95-104 `imm_score_table_scores` building the 1364-entry
fragment tables).  The imm source is not vendored in the reference; the model
below is reconstructed from the published Deciphon frame-profile description
and validated by exact normalization identities (see tests/test_frame.py).

Generative model
----------------
A frame state owns a codon distribution p(z1 z2 z3) and a background
nucleotide distribution q(x) (the codon-marginal nucleotide frequencies,
c-core/model.c:372-390).  To emit one fragment F of length t ∈ {1..5}:

1. draw the intended codon (z1, z2, z3) ~ p;
2. draw a number of deletions  d ~ Binomial(2, ε)  and, independently,
   a number of insertions      i ~ Binomial(2, ε);
   the fragment length is t = 3 - d + i;
3. choose uniformly which d of the 3 codon positions are deleted
   (1 / C(3,d)), and uniformly which i of the t observed positions carry
   insertions (1 / C(t,i));
4. the surviving codon bases appear in order at the non-insertion observed
   positions; each inserted base is drawn independently from q.

Hence

  p(F = x_1..x_t) =
    Σ_{(d,i): 3-d+i=t}  Bin(2,ε,d) · Bin(2,ε,i) / (C(3,d) · C(t,i))
      · Σ_{S ⊆ [t], |S|=i}  Π_{j∈S} q(x_j)
         · Σ_{D ⊆ [3], |D|=d}  p_marg(codon pattern: kept x's in order at
                                       positions [3]∖D, 'any' at D)

Valid (d, i) pairs per length: t=1:(2,0); t=2:(1,0),(2,1);
t=3:(0,0),(1,1),(2,2); t=4:(0,1),(1,2); t=5:(0,2).

This reproduces the constants of imm/nmm's closed forms, e.g. the length-1
coefficient ε²(1-ε)²/3 and the length-2 coefficients 2ε(1-ε)³/3 and
ε³(1-ε)/3, and satisfies Σ_F p(F) = 1 exactly.

Fragment code layout
--------------------
Fragments of length n use codes offset[n-1] + Σ_i sym_i·4^(n-1-i) with
offsets (0, 4, 20, 84, 340); total 4+16+64+256+1024 = 1364
(= c-core/viterbi.c:13 TABLE_SIZE, protein_node_size.h).  The same layout is
used by the sequence fragment-code precompute (scan/sequence.py), which is
all that matters for correctness.

The benchmark's frozen copy of the arithmetic of
deciphon_tpu/frame.py (and of deciphon_tpu_torch's copy of it); the reference never
imports the program.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import combinations

import numpy as np

NUM_NUCLT = 4
TABLE_SIZE = 1364
FRAG_OFFSETS = (0, 4, 20, 84, 340)  # code offset for lengths 1..5
MAX_FRAG = 5

# (d, i) combinations per fragment length t = 3 - d + i.
_DI_BY_LEN = {
    1: [(2, 0)],
    2: [(1, 0), (2, 1)],
    3: [(0, 0), (1, 1), (2, 2)],
    4: [(0, 1), (1, 2)],
    5: [(0, 2)],
}

# Enumerate the 6 distinct (d, i) classes and index them.
_DI_CLASSES = [(0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1), (0, 2), (1, 2), (2, 2)]
_DI_INDEX = {di: j for j, di in enumerate(_DI_CLASSES)}

_ANY = 4  # 'any' marker in a codon pattern position


def _comb(n, k):
    from math import comb

    return comb(n, k)


def frag_code(symbols) -> int:
    """Fragment (tuple of base indices 0..3) -> table code."""
    n = len(symbols)
    c = FRAG_OFFSETS[n - 1]
    mult = 1
    for s in reversed(symbols):
        c += int(s) * mult
        mult *= 4
    return c


def frag_symbols(code: int) -> tuple[int, ...]:
    """Inverse of frag_code."""
    for n in range(MAX_FRAG, 0, -1):
        if code >= FRAG_OFFSETS[n - 1]:
            rest = code - FRAG_OFFSETS[n - 1]
            out = []
            for _ in range(n):
                out.append(rest % 4)
                rest //= 4
            return tuple(reversed(out))
    raise ValueError(code)


def pattern_index(pattern) -> int:
    """Codon pattern (3 entries in 0..4, 4='any') -> flat index in [0,125)."""
    a, b, c = pattern
    return (a * 5 + b) * 5 + c


@lru_cache(maxsize=1)
def _term_tables():
    """Static per-fragment term enumeration.

    Returns (di_class, pattern_idx, ins0, ins1, nterms):
      di_class:    (1364, T) int32, index into _DI_CLASSES, -1 padding
      pattern_idx: (1364, T) int32, index into the 125 codon-marginal patterns
      ins0, ins1:  (1364, T) int32, inserted-base symbol indices or -1
      where T is the max term count over all fragments.
    """
    all_terms: list[list[tuple[int, int, int, int]]] = []
    for code in range(TABLE_SIZE):
        xs = frag_symbols(code)
        t = len(xs)
        terms = []
        for d, i in _DI_BY_LEN[t]:
            cls = _DI_INDEX[(d, i)]
            for S in combinations(range(t), i):
                kept = [xs[j] for j in range(t) if j not in S]
                ins = [xs[j] for j in S]
                ins0 = ins[0] if len(ins) > 0 else -1
                ins1 = ins[1] if len(ins) > 1 else -1
                for D in combinations(range(3), d):
                    pattern = [_ANY] * 3
                    ki = 0
                    for pos in range(3):
                        if pos not in D:
                            pattern[pos] = kept[ki]
                            ki += 1
                    assert ki == len(kept)
                    terms.append((cls, pattern_index(pattern), ins0, ins1))
        all_terms.append(terms)

    T = max(len(ts) for ts in all_terms)
    di_class = np.full((TABLE_SIZE, T), -1, dtype=np.int32)
    pat = np.zeros((TABLE_SIZE, T), dtype=np.int32)
    ins0 = np.full((TABLE_SIZE, T), -1, dtype=np.int32)
    ins1 = np.full((TABLE_SIZE, T), -1, dtype=np.int32)
    for c, ts in enumerate(all_terms):
        for j, (cls, pi, a, b) in enumerate(ts):
            di_class[c, j] = cls
            pat[c, j] = pi
            ins0[c, j] = a
            ins1[c, j] = b
    return di_class, pat, ins0, ins1


def _di_class_logconst(epsilon: float) -> np.ndarray:
    """log[ Bin(2,ε,d)·Bin(2,ε,i) / (C(3,d)·C(t,i)) ] for each (d,i) class."""
    eps = float(epsilon)
    with np.errstate(divide="ignore"):
        loge = np.log(eps) if eps > 0 else -np.inf
        log1e = np.log1p(-eps) if eps < 1 else -np.inf

    def logbin(k):
        if k == 0:
            return 2 * log1e
        if k == 1:
            return np.log(2.0) + loge + log1e
        return 2 * loge

    out = np.empty(len(_DI_CLASSES))
    for j, (d, i) in enumerate(_DI_CLASSES):
        t = 3 - d + i
        out[j] = logbin(d) + logbin(i) - np.log(_comb(3, d)) - np.log(_comb(t, i))
    return out


def codon_marginals(codon_lprobs: np.ndarray) -> np.ndarray:
    """(..., 4, 4, 4) codon log-probs -> (..., 5, 5, 5) marginals.

    Index 4 on each axis is 'any' = logsumexp over that axis (the
    imm_codon_marg semantics used by c-core/model.c marginal queries).
    """
    x = np.asarray(codon_lprobs, dtype=np.float64)

    def extend(arr, axis):
        with np.errstate(divide="ignore", over="ignore"):
            m = np.max(arr, axis=axis, keepdims=True)
            safe_m = np.where(np.isfinite(m), m, 0.0)
            s = np.log(np.sum(np.exp(arr - safe_m), axis=axis, keepdims=True)) + safe_m
            s = np.where(np.isfinite(m), s, -np.inf)
        return np.concatenate([arr, s], axis=axis)

    for ax in (-3, -2, -1):
        x = extend(x, ax)
    return x


def nuclt_marginal_lprobs(codon_lprobs: np.ndarray) -> np.ndarray:
    """Codon log-probs -> background nucleotide log-probs q.

    Parity: c-core/model.c:372-390 nuclt_lprob — for every codon, add
    lprob - log(3) into each of its three positions' buckets.
    """
    x = np.asarray(codon_lprobs, dtype=np.float64)
    batch = x.shape[:-3]
    x = x.reshape(batch + (64,))
    q = np.full(batch + (4,), -np.inf)
    # accumulate in probability space (equivalent, stable enough in f64)
    p = np.exp(x) / 3.0
    acc = np.zeros(batch + (4,))
    for ci in range(64):
        a, b, c = ci // 16, (ci // 4) % 4, ci % 4
        acc[..., a] += p[..., ci]
        acc[..., b] += p[..., ci]
        acc[..., c] += p[..., ci]
    with np.errstate(divide="ignore"):
        q = np.log(acc)
    return q


@lru_cache(maxsize=8)
def emission_feature_matrix(epsilon: float) -> np.ndarray:
    """Static (3125, 1364) f64 matrix W for the one-GEMM press.

    The term-enumeration logsumexp is *bilinear* in the exponentiated
    codon marginals pm and the insertion-base probabilities qe:
      p(F) = Σ_j exp(const_j) * qe[ins0_j] * qe[ins1_j] * pm[pattern_j]
    so with features X[(p, a, b)] = pm[p] * qe[a] * qe[b] (125 patterns x
    5 x 5 insertion symbols, slot 4 = "none" = 1) the whole table is one
    (K, 3125) x (3125, 1364) GEMM — the MXU-shaped formulation of the
    press hot loop (c-core/protein.c:95-104, OpenMP over nodes).
    """
    di_class, pat, ins0, ins1 = _term_tables()
    consts = _di_class_logconst(epsilon)
    consts_pad = np.concatenate([consts, [0.0]])  # padding never selected
    w = np.where(di_class >= 0,
                 np.exp(consts_pad[np.maximum(di_class, 0)]), 0.0)  # (C, T)
    a = np.where(ins0 >= 0, ins0, 4)
    b = np.where(ins1 >= 0, ins1, 4)
    feat = (pat * 5 + a) * 5 + b  # (C, T) feature index
    W = np.zeros((125 * 25, TABLE_SIZE))
    np.add.at(W, (feat.ravel(), np.repeat(np.arange(TABLE_SIZE),
                                          feat.shape[1])), w.ravel())
    return W


def emission_table(codon_lprobs: np.ndarray, epsilon: float,
                   nuclt_lprobs: np.ndarray | None = None) -> np.ndarray:
    """Build the (..., 1364) fragment log-prob table (one-GEMM fast path).

    Args:
      codon_lprobs: (..., 4, 4, 4) normalized codon log-probs (any number of
        leading batch dims, e.g. K profile nodes).
      epsilon: the indel error probability ε.
      nuclt_lprobs: optional (..., 4) background nucleotide log-probs; if
        None, derived from the codon marginals (the reference always derives
        them this way, c-core/model.c:439).

    Returns float64 (..., 1364) table;  Σ exp(table) == 1 per batch element.
    """
    x = np.asarray(codon_lprobs, dtype=np.float64)
    if nuclt_lprobs is None:
        q = nuclt_marginal_lprobs(x)
    else:
        q = np.asarray(nuclt_lprobs, dtype=np.float64)
    marg = codon_marginals(x)  # (..., 5,5,5)
    batch = marg.shape[:-3]
    pm = np.exp(marg.reshape(batch + (125,)))
    qe = np.concatenate([np.exp(q), np.ones(batch + (1,))], axis=-1)  # (...,5)

    qp = qe[..., :, None] * qe[..., None, :]  # (..., 5, 5)
    X = (pm[..., :, None] * qp.reshape(batch + (1, 25))).reshape(
        batch + (125 * 25,))
    W = emission_feature_matrix(float(epsilon))
    p = X @ W
    with np.errstate(divide="ignore"):
        return np.log(p)


def match_pattern_matrix() -> np.ndarray:
    """(125, 64) float64 matrix: 0.0 where codon matches pattern, -inf else.

    pattern p matches codon z iff every position of p that is not 'any'
    equals the codon base.  Used to turn marginal-pattern term tables into
    conditional p(F|z) term tables: marg[pattern] -> match[pattern, z].
    """
    out = np.full((125, 64), -np.inf)
    for pi in range(125):
        a, b, c = pi // 25, (pi // 5) % 5, pi % 5
        for zi in range(64):
            za, zb, zc = zi // 16, (zi // 4) % 4, zi % 4
            if (a in (za, 4)) and (b in (zb, 4)) and (c in (zc, 4)):
                out[pi, zi] = 0.0
    return out

