"""Profile construction: HMMER3 amino profile -> frame-aware nucleotide profile.

This is the "press" math, re-expressed as dense array computation.

Parity targets in the reference:
  - c-core/model.c:392-426  codon_lprob     (amino lodds -> codon log-probs)
  - c-core/model.c:372-390  nuclt_lprob     (codon -> nucleotide marginals)
  - c-core/model.c:428-441  setup_nuclt_dist
  - c-core/model.c:284-309  calculate_occupancy (entry distribution)
  - c-core/model.c:443-473  setup_entry_trans (uniform | occupancy)
  - c-core/hmm_reader.c:79-103 Swiss-Prot null amino frequencies
  - c-core/protein.c:67-120 protein_absorb  (emission score tables)
  - c-core/protein.c:353-394 protein_setup_viterbi (negated cost layout)

The benchmark's frozen copy of the press arithmetic of
deciphon_tpu/profile.py (and of deciphon_tpu_torch's copy of it).
`press_profile` takes the drawn parameters as plain arrays (an
`HMMParams`), never an object of the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import frame
from .gencode import Gencode, get_gencode

NUM_AMINO = 20
# transition columns, hmmfile order
T_MM, T_MI, T_MD, T_IM, T_II, T_DM, T_DD = range(7)


@dataclass
class HMMParams:
    """One drawn profile: log-probabilities as plain arrays."""

    name: str
    match_lprobs: np.ndarray  # (K, 20) f32
    trans: np.ndarray  # (K+1, 7) f32, row 0 the BEGIN line
    null_lprobs: np.ndarray  # (20,) f64

    @property
    def length(self) -> int:
        return self.match_lprobs.shape[0]

INF = np.float32(np.inf)

ENTRY_DIST_UNIFORM = 1
ENTRY_DIST_OCCUPANCY = 2

# HMMER3 Swiss-Prot 50.8 amino frequencies (c-core/hmm_reader.c:79-103),
# order ACDEFGHIKLMNPQRSTVWY.
NULL_AMINO_FREQS = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062,
    0.0695071, 0.0229198, 0.0590092, 0.0594422, 0.0963728,
    0.0237718, 0.0414386, 0.0482904, 0.0395639, 0.0540978,
    0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
], dtype=np.float64)
NULL_AMINO_LPROBS = np.log(NULL_AMINO_FREQS)


def codon_lprobs_from_amino(amino_lprobs: np.ndarray, gencode: Gencode) -> np.ndarray:
    """Amino log-weights -> normalized codon log-probs.

    Parity: c-core/model.c:392-426 + imm_codon_lprob_normalize.
    Each codon coding amino a gets weight lprobs[a] / count(a); stop codons
    get probability zero; the result is normalized over the 64 codons.

    amino_lprobs: (..., 20).  Returns (..., 4, 4, 4) float64.
    """
    amino_lprobs = np.asarray(amino_lprobs, dtype=np.float64)
    batch = amino_lprobs.shape[:-1]

    amino_idx = gencode.amino_idx  # (64,) int8, -1 for stops
    counts = np.zeros(NUM_AMINO, dtype=np.int64)
    for ai in amino_idx:
        if ai >= 0:
            counts[ai] += 1
    log_counts = np.where(counts > 0, np.log(np.maximum(counts, 1)), 0.0)

    per_amino = amino_lprobs - log_counts  # (..., 20)
    codon = np.full(batch + (64,), -np.inf)
    sense = amino_idx >= 0
    codon[..., sense] = per_amino[..., amino_idx[sense].astype(np.int64)]

    # normalize over codons
    with np.errstate(over="ignore"):
        m = np.max(codon, axis=-1, keepdims=True)
        z = np.log(np.sum(np.exp(codon - m), axis=-1, keepdims=True)) + m
    codon = codon - z
    return codon.reshape(batch + (4, 4, 4))


def occupancy(trans: np.ndarray) -> np.ndarray:
    """Match-occupancy entry distribution (c-core/model.c:284-309).

    trans: (K+1, 7) log-prob transitions (trans[0] = BEGIN node line).
    Returns BMk: (K,) log entry probabilities.
    """
    K = trans.shape[0] - 1
    locc = np.empty(K, dtype=np.float64)
    t = trans.astype(np.float64)
    locc[0] = np.logaddexp(t[0, T_MI], t[0, T_MM])
    for i in range(1, K):
        v0 = locc[i - 1] + np.logaddexp(t[i, T_MM], t[i, T_MI])
        with np.errstate(divide="ignore"):
            log1_p = np.log1p(-np.exp(locc[i - 1]))
        v1 = log1_p + t[i, T_DM]
        locc[i] = np.logaddexp(v0, v1)
    logz = -np.inf
    for i in range(K):
        logz = np.logaddexp(logz, locc[i] + np.log(K - i))
    return (locc - logz).astype(np.float64)


def uniform_entry(K: int) -> np.ndarray:
    """Uniform entry distribution (c-core/model.c:445-457).

    Note the reference's peculiar constant: cost = log(2/(M(M+1))) * M is a
    bug-for-bug float expression; we reproduce log(2/(M(M+1))) per entry?
    No: the reference sets every B->Mk to `logf(2.0/(M*(M+1))) * M`.  We
    replicate that expression verbatim.
    """
    M = float(K)
    cost = np.log(2.0 / (M * (M + 1.0))) * M
    return np.full(K, cost, dtype=np.float64)


@dataclass
class FrameProfile:
    """A pressed frame-aware profile: everything the scan engine needs.

    Score conventions: all arrays here are *log-probabilities* (the .dcp
    convention); the Viterbi kernel negates them into min-plus costs
    (c-core/protein.c:353-394).
    """

    accession: str
    name: str
    core_size: int
    consensus: str
    gencode_id: int
    epsilon: float
    entry_dist: int
    has_ga: bool

    # (K+1, 7) transitions leaving node j (trans[0] = BEGIN line)
    trans: np.ndarray = field(repr=False)
    # (K,) log entry distribution B->M_k
    BMk: np.ndarray = field(repr=False)
    # (K+1, 1364) match fragment log-probs (node K duplicates node K-1,
    # matching protein_absorb's nodes[core_size] row, c-core/protein.c:96-104)
    match_emission: np.ndarray = field(repr=False)
    # (1364,) null (R-state) and background (insert) fragment log-probs
    null_emission: np.ndarray = field(repr=False)
    bg_emission: np.ndarray = field(repr=False)
    # codon log-prob cubes for the ML decoder
    match_codon_lprobs: np.ndarray = field(repr=False)  # (K+1, 4,4,4)
    null_codon_lprobs: np.ndarray = field(repr=False)  # (4,4,4)
    bg_codon_lprobs: np.ndarray = field(repr=False)  # (4,4,4)

    def __post_init__(self):
        assert self.trans.shape == (self.core_size + 1, 7)
        assert self.BMk.shape == (self.core_size,)
        assert self.match_emission.shape == (self.core_size + 1, frame.TABLE_SIZE)


def press_profile(hmm: HMMParams, gencode_id: int, epsilon: float,
                  entry_dist: int = ENTRY_DIST_OCCUPANCY) -> FrameProfile:
    """Press one HMMER3 profile into a frame-aware profile.

    Mirrors the reference press pipeline: hmm_reader_next + model build +
    protein_absorb (c-core/press.c:127-190).
    """
    gc = get_gencode(gencode_id)
    K = hmm.length
    null_amino_lprobs = np.asarray(hmm.null_lprobs, np.float64)

    # Match states: log-odds vs the null amino distribution
    # (c-core/model.c:70-72), then codon distribution per node.
    lodds = hmm.match_lprobs.astype(np.float64) - null_amino_lprobs[None, :]
    match_codons = codon_lprobs_from_amino(lodds, gc)  # (K, 4,4,4)

    # Insert/background distribution: lodds = 0 (c-core/model.c:151-155).
    zero = np.zeros(NUM_AMINO)
    bg_codons = codon_lprobs_from_amino(zero, gc)
    # Null (R state) distribution from the null amino lprobs directly
    # (c-core/model.c:142-143).
    null_codons = codon_lprobs_from_amino(null_amino_lprobs, gc)

    # Emission tables.
    match_em = frame.emission_table(match_codons, epsilon)  # (K, 1364)
    # nodes[core_size] duplicates the last node (protein.c:99 min(i, K-1)).
    match_em = np.concatenate([match_em, match_em[-1:]], axis=0)
    match_codons_full = np.concatenate([match_codons, match_codons[-1:]], axis=0)
    null_em = frame.emission_table(null_codons, epsilon)
    bg_em = frame.emission_table(bg_codons, epsilon)

    if entry_dist == ENTRY_DIST_OCCUPANCY:
        BMk = occupancy(hmm.trans)
    else:
        BMk = uniform_entry(K)

    return FrameProfile(
        accession=hmm.name,
        name=hmm.name,
        core_size=K,
        consensus="-" * K,
        gencode_id=gencode_id,
        epsilon=epsilon,
        entry_dist=entry_dist,
        has_ga=False,
        trans=hmm.trans.astype(np.float32),
        BMk=BMk.astype(np.float32),
        match_emission=match_em.astype(np.float32),
        null_emission=null_em.astype(np.float32),
        bg_emission=bg_em.astype(np.float32),
        match_codon_lprobs=match_codons_full.astype(np.float32),
        null_codon_lprobs=null_codons.astype(np.float32),
        bg_codon_lprobs=bg_codons.astype(np.float32),
    )
