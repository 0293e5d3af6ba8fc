"""NCBI genetic-code tables (translation tables).

Functional parity targets:
  - schema/deciphon_schema/__init__.py:229-258 (Gencode IntEnum ids)
  - imm gencode usage: c-core/model.c:372-426 (codon<->amino mapping and
    per-amino codon counts), c-core/match.c:79 (codon -> amino decode)

Data is the standard public NCBI translation-table data (AAs strings in the
canonical NCBI codon order TTT, TTC, TTA, TTG, TCT, ... i.e. bases ordered
T, C, A, G).  Internally we re-index codons in alphabetical base order
(A,C,G,T = 0..3): codon_index = a*16 + b*4 + c.

The benchmark's frozen copy of the arithmetic of
deciphon_tpu/gencode.py (and of deciphon_tpu_torch's copy of it); the reference never
imports the program.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# NCBI id -> (name, AAs string in NCBI TCAG codon order). '*' = stop.
_NCBI_TABLES: dict[int, tuple[str, str]] = {
    1: ("Standard", "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    2: ("Vertebrate Mitochondrial", "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG"),
    3: ("Yeast Mitochondrial", "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    4: ("Mold/Protozoan Mitochondrial", "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    5: ("Invertebrate Mitochondrial", "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG"),
    6: ("Ciliate/Dasycladacean/Hexamita Nuclear", "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    9: ("Echinoderm/Flatworm Mitochondrial", "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG"),
    10: ("Euplotid Nuclear", "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    11: ("Bacterial/Archaeal/Plant Plastid", "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    12: ("Alternative Yeast Nuclear", "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    13: ("Ascidian Mitochondrial", "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG"),
    14: ("Alternative Flatworm Mitochondrial", "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG"),
    15: ("Blepharisma Macronuclear", "FFLLSSSSYY*QCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    16: ("Chlorophycean Mitochondrial", "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    21: ("Trematode Mitochondrial", "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG"),
    22: ("Scenedesmus obliquus Mitochondrial", "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    23: ("Thraustochytrium Mitochondrial", "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    24: ("Rhabdopleuridae Mitochondrial", "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSSKVVVVAAAADDEEGGGG"),
    25: ("Candidate Division SR1/Gracilibacteria", "FFLLSSSSYY**CCGWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    26: ("Pachysolen tannophilus Nuclear", "FFLLSSSSYY**CC*WLLLAPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    27: ("Karyorelict Nuclear", "FFLLSSSSYYQQCCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    28: ("Condylostoma Nuclear", "FFLLSSSSYYQQCCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    29: ("Mesodinium Nuclear", "FFLLSSSSYYYYCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    30: ("Peritrich Nuclear", "FFLLSSSSYYEECC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    31: ("Blastocrithidia Nuclear", "FFLLSSSSYYEECCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    32: ("Balanophoraceae Plastid", "FFLLSSSSYY*WCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    33: ("Cephalodiscidae Mitochondrial", "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSSKVVVVAAAADDEEGGGG"),
}

GENCODE_IDS = tuple(sorted(_NCBI_TABLES))

_NCBI_BASE_ORDER = "TCAG"
_STOP = "*"


class Gencode:
    """A genetic-code table in alphabetical (ACGT) codon indexing.

    Attributes:
      id:        NCBI table id.
      name:      NCBI table name.
      aminos:    length-64 str; aminos[codon_index] is the amino one-letter
                 code or '*' for stop, codon_index = a*16+b*4+c, ACGT order.
      amino_idx: (64,) int8 array; index into alphabet.AMINO, or -1 for stop.
    """

    def __init__(self, gid: int):
        if gid not in _NCBI_TABLES:
            raise ValueError(f"unknown NCBI genetic code id {gid}")
        from .alphabet import AMINO_INDEX

        self.id = gid
        name, aas_ncbi = _NCBI_TABLES[gid]
        self.name = name
        aminos = [""] * 64
        k = 0
        for b1 in _NCBI_BASE_ORDER:
            for b2 in _NCBI_BASE_ORDER:
                for b3 in _NCBI_BASE_ORDER:
                    idx = ("ACGT".index(b1) * 16 + "ACGT".index(b2) * 4
                           + "ACGT".index(b3))
                    aminos[idx] = aas_ncbi[k]
                    k += 1
        self.aminos = "".join(aminos)
        self.amino_idx = np.array(
            [AMINO_INDEX.get(a, -1) for a in self.aminos], dtype=np.int8
        )

    def decode(self, codon_index: int) -> str:
        """Codon index -> amino one-letter code ('*' for stop).

        Parity: imm_gencode_decode (c-core/match.c:79).
        """
        return self.aminos[codon_index]


@lru_cache(maxsize=None)
def get_gencode(gid: int) -> Gencode:
    return Gencode(gid)


def codon_index(a: int, b: int, c: int) -> int:
    return a * 16 + b * 4 + c


def codon_symbols(idx: int) -> str:
    return "ACGT"[idx // 16] + "ACGT"[(idx // 4) % 4] + "ACGT"[idx % 4]
