"""Alphabets: DNA/RNA/amino IUPAC, plus ambiguity disambiguation.

Functional parity targets (reference: EBI-Metagenomics/deciphon):
  - c-core/disambiguate.c:38-86  (IUPAC ambiguity -> most-frequent concrete base)
  - c-core/sequence.c:47-84      (uppercase, DNA/RNA mismatch detection)
  - imm alphabets: dna "ACGT", rna "ACGU", amino "ACDEFGHIKLMNPQRSTVWY"

TPU-first design note: sequences become int8 arrays of symbol indices the
moment they enter the framework; every later stage (fragment-code precompute,
Viterbi emission gathers) is pure array math.

The benchmark's frozen copy of the arithmetic of
deciphon_tpu/alphabet.py (and of deciphon_tpu_torch's copy of it); the reference never
imports the program.
"""

from __future__ import annotations

import numpy as np

DNA = "ACGT"
RNA = "ACGU"
AMINO = "ACDEFGHIKLMNPQRSTVWY"

DNA_ANY = "X"
AMINO_ANY = "X"

AMINO_INDEX = {c: i for i, c in enumerate(AMINO)}
DNA_INDEX = {c: i for i, c in enumerate(DNA)}
RNA_INDEX = {c: i for i, c in enumerate(RNA)}

# IUPAC ambiguity codes -> candidate concrete-base index sets (A,C,G,T/U = 0..3).
# Mirrors c-core/disambiguate.c:62-73 (X treated like N).
IUPAC_SETS = {
    "R": (0, 2),
    "Y": (1, 3),
    "M": (0, 1),
    "K": (2, 3),
    "S": (1, 2),
    "W": (0, 3),
    "H": (0, 1, 3),
    "B": (1, 2, 3),
    "V": (0, 1, 2),
    "D": (0, 2, 3),
    "N": (0, 1, 2, 3),
    "X": (0, 1, 2, 3),
}


class InvalidSequenceError(ValueError):
    pass


class MixedTUError(InvalidSequenceError):
    """Sequence contains both T and U (c-core/disambiguate.c:50 DCP_ENUCLTSEQTU)."""


def disambiguate(seq: str) -> str:
    """Resolve IUPAC ambiguity codes to the most frequent concrete base.

    Reference semantics (c-core/disambiguate.c): count A/C/G/T/U occurrences
    over the whole sequence; each ambiguity code resolves to its candidate
    with the highest count (first candidate wins ties, in the fixed candidate
    order).  Rejects sequences mixing T and U.
    """
    seq = seq.upper()
    counts = {0: 0, 1: 0, 2: 0, 3: 0, 4: 0}  # A C G T U
    for ch in seq:
        if ch == "A":
            counts[0] += 1
        elif ch == "C":
            counts[1] += 1
        elif ch == "G":
            counts[2] += 1
        elif ch == "T":
            counts[3] += 1
        elif ch == "U":
            counts[4] += 1
    if counts[3] > 0 and counts[4] > 0:
        raise MixedTUError("sequence mixes T and U")

    def resolve(candidates):
        best = candidates[0]
        best_count = counts[best]
        for c in candidates[1:]:
            if counts[c] > best_count:
                best, best_count = c, counts[c]
        return "ACGT"[best]

    out = []
    for ch in seq:
        if ch in IUPAC_SETS:
            out.append(resolve(IUPAC_SETS[ch]))
        else:
            out.append(ch)
    return "".join(out)


def encode_dna(seq: str, *, is_rna_db: bool = False) -> np.ndarray:
    """Encode an (already disambiguated, uppercase) sequence to int8 indices.

    Accepts T or U uniformly (a DNA database scans RNA reads and vice versa;
    the reference detects the mismatch in sequence.c:66-76 and reports a
    dedicated error — here we simply normalize, since after disambiguation
    T and U map to the same index 3).
    """
    table = np.full(256, -1, dtype=np.int8)
    for i, c in enumerate(DNA):
        table[ord(c)] = i
    table[ord("U")] = 3
    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    idx = table[arr]
    if (idx < 0).any():
        bad = chr(arr[int(np.argmax(idx < 0))])
        raise InvalidSequenceError(f"invalid nucleotide symbol {bad!r}")
    return idx


def prepare_sequence(raw: str) -> np.ndarray:
    """uppercase -> disambiguate -> int8 encode (reference sequence_init path)."""
    return encode_dna(disambiguate(raw))
