"""Maximum-likelihood codon decoding of matched fragments.

Parity: c-core/decoder.c:38-58 (decoder_decode via imm_frame_cond_decode)
and c-core/match.c:66-81 (match_amino).

For a path step that emitted fragment F in state s, the decoder picks
  argmax_z  [ log p(z | s) + log p(F | z) ]
where p(z|s) is the state's codon distribution (match node k's distribution,
the background distribution for inserts, the null distribution otherwise)
and p(F|z) is the conditional ε-frame emission model (frame.py derivation
with the codon fixed).

The benchmark's frozen copy of the arithmetic of
deciphon_tpu/scan/decoder.py (and of deciphon_tpu_torch's copy of it); the reference never
imports the program.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import states as st
from .frame import (FRAG_OFFSETS, _di_class_logconst, _term_tables,
                     match_pattern_matrix, nuclt_marginal_lprobs)
from .gencode import codon_symbols, get_gencode
from .press import FrameProfile


@lru_cache(maxsize=8)
def _static_tables():
    di_class, pat, ins0, ins1 = _term_tables()
    return di_class, pat, ins0, ins1, match_pattern_matrix()


class Decoder:
    """Per-profile decoder with cached distributions."""

    def __init__(self, profile: FrameProfile):
        self.profile = profile
        self.gencode = get_gencode(profile.gencode_id)
        self.epsilon = profile.epsilon
        # codon log-prob cubes flattened to (n, 64)
        self.match_codons = profile.match_codon_lprobs.reshape(
            profile.core_size + 1, 64).astype(np.float64)
        self.null_codons = profile.null_codon_lprobs.reshape(64).astype(np.float64)
        self.bg_codons = profile.bg_codon_lprobs.reshape(64).astype(np.float64)
        # per-distribution background nucleotide lprobs (q)
        self.match_q = nuclt_marginal_lprobs(
            profile.match_codon_lprobs.astype(np.float64))
        self.null_q = nuclt_marginal_lprobs(
            profile.null_codon_lprobs.astype(np.float64))
        self.bg_q = nuclt_marginal_lprobs(
            profile.bg_codon_lprobs.astype(np.float64))
        self._consts = _di_class_logconst(profile.epsilon)

    def _dist_for(self, sid: int):
        if st.is_insert(sid):
            return self.bg_codons, self.bg_q
        if st.is_match(sid):
            k = st.core_idx(sid)
            return self.match_codons[k], self.match_q[k]
        # N, J, C (and R in the null model) use the null distribution
        return self.null_codons, self.null_q

    def decode(self, sid: int, frag_code: int) -> int:
        """Return the ML codon index (0..63) for this step's fragment."""
        codons, q = self._dist_for(sid)
        cond = self._cond_scores(frag_code, q)  # (64,)
        joint = codons + cond
        zi = int(np.argmax(joint))
        if not np.isfinite(joint[zi]):
            raise ValueError(
                f"cannot decode fragment code {frag_code} in state {sid}")
        return zi

    def decode_codon_amino(self, sid: int, frag_code: int) -> tuple[str, str]:
        zi = self.decode(sid, frag_code)
        return codon_symbols(zi), self.gencode.decode(zi)

    def _cond_scores(self, frag_code: int, q: np.ndarray) -> np.ndarray:
        """log p(F | z) for all 64 codons, one fragment."""
        di_class, pat, ins0, ins1, match = _static_tables()
        cls = di_class[frag_code]  # (T,)
        valid = cls >= 0
        consts = np.where(valid, self._consts[np.maximum(cls, 0)], -np.inf)
        qx = np.concatenate([q, [0.0]])
        ins_term = qx[ins0[frag_code]] + qx[ins1[frag_code]]  # (T,)
        # (T, 64): per-term, per-codon
        terms = consts[:, None] + match[pat[frag_code]] + ins_term[:, None]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            m = terms.max(axis=0)
            safe = np.where(np.isfinite(m), m, 0.0)
            out = np.log(np.exp(terms - safe).sum(axis=0)) + safe
            out = np.where(np.isfinite(m), out, -np.inf)
        return out
