"""Maximum-likelihood codon decoding of matched fragments.

Parity: c-core/decoder.c:38-58 (decoder_decode via imm_frame_cond_decode)
and c-core/match.c:66-81 (match_amino).

For a path step that emitted fragment F in state s, the decoder picks
  argmax_z  [ log p(z | s) + log p(F | z) ]
where p(z|s) is the state's codon distribution (match node k's distribution,
the background distribution for inserts, the null distribution otherwise)
and p(F|z) is the conditional ε-frame emission model (frame.py derivation
with the codon fixed).

The port's own copy of deciphon_tpu/scan/decoder.py, kept equal in behaviour
(tests/test_torch_copies.py compares the two).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .. import states as st
from ..frame import (FRAG_OFFSETS, _di_class_logconst, _term_tables,
                     match_pattern_matrix, nuclt_marginal_lprobs)
from ..gencode import codon_symbols, get_gencode
from ..profile import FrameProfile


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
        # (distribution, fragment code) -> ML codon memo: decoding is a
        # pure function of the pair and real scans repeat pairs heavily
        # (the same hit alignment recurs across reads), so survivor-heavy
        # scans decode mostly from this table.  A flat int16 plane
        # ((#distributions, 1364), 0 = unseen, else codon+1) replaces the
        # earlier dict — the per-step Python key/lookup loop was the
        # measured survivor-heavy host hot spot; the plane is ~0.5 MB at
        # K=200 and 45 MB at the reference's K=16384 ceiling.  Row 0 =
        # insert (bg), row 1 = specials (null), row 2+k = match node k.
        self._memo_zi = np.zeros(
            (self.match_codons.shape[0] + 2, 1364), np.int16)
        self._codon_sym = [codon_symbols(z) for z in range(64)]
        self._amino_sym = [self.gencode.decode(z) for z in range(64)]

    def _dist_key(self, sid: int) -> int:
        if st.is_insert(sid):
            return -1
        if st.is_match(sid):
            return st.core_idx(sid)
        return -2

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

    def decode_batch(self, sids, frag_codes) -> list[tuple[str, str]]:
        """Vectorized + memoized decode of many steps at once: identical
        results to decode_codon_amino per step; only (distribution,
        fragment) pairs never seen before pay the conditional-score
        math.  Fully array-vectorized — the per-step Python key loop of
        the dict memo was the measured survivor-heavy host cost."""
        B = len(sids)
        if B == 0:
            return []
        sids_a = np.asarray(sids, np.int64)
        fcs_a = np.asarray(frag_codes, np.int64)
        cls = sids_a >> 14
        core = (sids_a & 0x3FFF) - 1  # core_idx for M/I rows
        row = np.where(cls == 1, 0, np.where(cls == 0, core + 2, 1))
        zi = self._memo_zi[row, fcs_a]
        miss = np.nonzero(zi == 0)[0]
        if miss.size:
            fcs = fcs_a[miss]
            M = len(miss)
            codons = np.empty((M, 64), np.float64)
            q = np.empty((M, 4), np.float64)
            for j, i in enumerate(miss):
                codons[j], q[j] = self._dist_for(int(sids_a[i]))
            cond = self._cond_scores_batch(fcs, q)  # (M, 64)
            joint = codons + cond
            zis = np.argmax(joint, axis=1)
            best = joint[np.arange(M), zis]
            if not np.isfinite(best).all():
                bad = int(miss[int(np.argmin(np.isfinite(best)))])
                raise ValueError(
                    f"cannot decode fragment code {frag_codes[bad]} in "
                    f"state {sids[bad]}")
            self._memo_zi[row[miss], fcs] = zis.astype(np.int16) + 1
            zi = self._memo_zi[row, fcs_a]
        zi = zi - 1
        sym, aa = self._codon_sym, self._amino_sym
        return [(sym[z], aa[z]) for z in zi]

    def _cond_scores_batch(self, fcs: np.ndarray, q: np.ndarray) -> np.ndarray:
        """log p(F | z) for all 64 codons, one row per fragment."""
        di_class, pat, ins0, ins1, match = _static_tables()
        cls = di_class[fcs]  # (B, T)
        valid = cls >= 0
        consts = np.where(valid, self._consts[np.maximum(cls, 0)], -np.inf)
        qx = np.concatenate([q, np.zeros((len(fcs), 1))], axis=1)  # (B, 5)
        ins_term = (np.take_along_axis(qx, ins0[fcs], 1)
                    + np.take_along_axis(qx, ins1[fcs], 1))  # (B, T)
        terms = (consts[:, :, None] + match[pat[fcs]]
                 + ins_term[:, :, None])  # (B, T, 64)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            m = terms.max(axis=1)  # (B, 64)
            safe = np.where(np.isfinite(m), m, 0.0)
            out = (np.log(np.exp(terms - safe[:, None, :]).sum(axis=1))
                   + safe)
            return np.where(np.isfinite(m), out, -np.inf)

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
