"""Carry profiles, costs and sequences into the port as plain arrays.

The port shares no class with deciphon_tpu.  An object of that package (or
of any other producer: a .dcp reader, a test fixture) crosses over as its
fields, numpy arrays and scalars; the functions here build the port's own
object from them and check the shapes.  The caller does the unpacking, for
a dataclass e.g.

    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    profile = frame_profile_from_arrays(**fields)

Arrays are copied, so the two objects never share memory.
"""

from __future__ import annotations

import numpy as np

from .frame import TABLE_SIZE
from .hmmfile import NUM_AMINO, NUM_TRANS, HMMProfile
from .ops.costs import NUM_TRANS_VECS, ViterbiCosts
from .ops.engine import ProfilePack
from .profile import FrameProfile
from .scan.sequence import Sequence


def _array(a, dtype, shape, name: str) -> np.ndarray:
    a = np.array(a, dtype=dtype)  # always a copy
    if a.shape != tuple(shape):
        raise ValueError(f"{name}: shape {a.shape}, expected {tuple(shape)}")
    return a


def frame_profile_from_arrays(*, accession: str, name: str, core_size: int,
                              consensus: str, gencode_id: int,
                              epsilon: float, entry_dist: int, has_ga: bool,
                              trans, BMk, match_emission, null_emission,
                              bg_emission, match_codon_lprobs,
                              null_codon_lprobs, bg_codon_lprobs
                              ) -> FrameProfile:
    """A FrameProfile from its fields; every array keeps its dtype."""
    K = int(core_size)
    return FrameProfile(
        accession=str(accession), name=str(name), core_size=K,
        consensus=str(consensus), gencode_id=int(gencode_id),
        epsilon=float(epsilon), entry_dist=int(entry_dist),
        has_ga=bool(has_ga),
        trans=_array(trans, np.asarray(trans).dtype, (K + 1, 7), "trans"),
        BMk=_array(BMk, np.asarray(BMk).dtype, (K,), "BMk"),
        match_emission=_array(match_emission,
                              np.asarray(match_emission).dtype,
                              (K + 1, TABLE_SIZE), "match_emission"),
        null_emission=_array(null_emission, np.asarray(null_emission).dtype,
                             (TABLE_SIZE,), "null_emission"),
        bg_emission=_array(bg_emission, np.asarray(bg_emission).dtype,
                           (TABLE_SIZE,), "bg_emission"),
        match_codon_lprobs=_array(match_codon_lprobs,
                                  np.asarray(match_codon_lprobs).dtype,
                                  (K + 1, 4, 4, 4), "match_codon_lprobs"),
        null_codon_lprobs=_array(null_codon_lprobs,
                                 np.asarray(null_codon_lprobs).dtype,
                                 (4, 4, 4), "null_codon_lprobs"),
        bg_codon_lprobs=_array(bg_codon_lprobs,
                               np.asarray(bg_codon_lprobs).dtype,
                               (4, 4, 4), "bg_codon_lprobs"))


def hmm_profile_from_arrays(*, name: str, accession: str, description: str,
                            length: int, alphabet: str, consensus: str,
                            match_lprobs, trans, ga, compo, insert_lprobs,
                            stats) -> HMMProfile:
    """An HMMProfile (a parsed HMMER3 profile) from its fields; GA, the
    STATS lines and the optional arrays carried as they are."""
    K = int(length)

    def optional(a, shape, name):
        return None if a is None else _array(a, np.asarray(a).dtype, shape,
                                             name)

    return HMMProfile(
        name=str(name), accession=str(accession),
        description=str(description), length=K, alphabet=str(alphabet),
        consensus=str(consensus),
        match_lprobs=_array(match_lprobs, np.asarray(match_lprobs).dtype,
                            (K, NUM_AMINO), "match_lprobs"),
        trans=_array(trans, np.asarray(trans).dtype, (K + 1, NUM_TRANS),
                     "trans"),
        ga=None if ga is None else tuple(float(v) for v in ga),
        compo=optional(compo, (NUM_AMINO,), "compo"),
        insert_lprobs=optional(insert_lprobs, (K + 1, NUM_AMINO),
                               "insert_lprobs"),
        stats={str(k): tuple(float(v) for v in vals)
               for k, vals in stats.items()})


def costs_from_arrays(*, K: int, core, match, null, background, xt
                      ) -> ViterbiCosts:
    """ViterbiCosts from its fields (f32 min-plus costs)."""
    K = int(K)
    return ViterbiCosts(
        K=K,
        core=_array(core, np.float32, (NUM_TRANS_VECS, K), "core"),
        match=_array(match, np.float32, (TABLE_SIZE, K), "match"),
        null=_array(null, np.float32, (TABLE_SIZE,), "null"),
        background=_array(background, np.float32, (TABLE_SIZE,),
                          "background"),
        xt=_array(xt, np.float32, (13,), "xt"))


def profile_pack_from_arrays(*, K_pad: int, core, match, null, background,
                             core_sizes) -> ProfilePack:
    """ProfilePack from its fields: P profiles padded to K_pad nodes."""
    K_pad = int(K_pad)
    sizes = _array(core_sizes, np.int32, (len(core_sizes),), "core_sizes")
    P = sizes.shape[0]
    return ProfilePack(
        K_pad=K_pad,
        core=_array(core, np.float32, (P, NUM_TRANS_VECS, K_pad), "core"),
        match=_array(match, np.float32, (P, TABLE_SIZE, K_pad), "match"),
        null=_array(null, np.float32, (P, TABLE_SIZE), "null"),
        background=_array(background, np.float32, (P, TABLE_SIZE),
                          "background"),
        core_sizes=sizes)


def sequence_from_arrays(*, id: int, name: str, data: str, symbols, codes
                         ) -> Sequence:
    """A prepared Sequence from its fields: `data` the uppercase
    disambiguated bases, `symbols` (L,) int8 base indices, `codes` (L, 5)
    int32 END-indexed fragment codes."""
    symbols = np.asarray(symbols)
    L = symbols.shape[0]
    if len(data) != L:
        raise ValueError(f"data has {len(data)} symbols, symbols {L}")
    return Sequence(id=int(id), name=str(name), data=str(data),
                    symbols=_array(symbols, np.int8, (L,), "symbols"),
                    codes=_array(codes, np.int32, (L, 5), "codes"))
