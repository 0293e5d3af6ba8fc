"""FASTA / JSON sequence input (parity: cli/deciphon/read_sequences.py).

Sequence ids are 1-based input order, matching the reference CLI
(cli/deciphon/read_sequences.py:16-36 enumerate over FASTA items).
"""

from __future__ import annotations

import json
import os

from .sequence import Sequence

__all__ = ["read_fasta", "read_sequences"]


def read_fasta(path_or_fp):
    """Yield (defline, sequence) pairs."""
    fp = path_or_fp
    close = False
    if not hasattr(fp, "read"):
        fp = open(fp, "rt")
        close = True
    try:
        defline = None
        chunks: list[str] = []
        for line in fp:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if defline is not None:
                    yield defline, "".join(chunks)
                defline = line[1:].strip()
                chunks = []
            else:
                if defline is None:
                    raise ValueError("FASTA data before first '>' defline")
                chunks.append(line)
        if defline is not None:
            yield defline, "".join(chunks)
    finally:
        if close:
            fp.close()


def read_sequences(path) -> list[Sequence]:
    """Read sequences from .fasta/.fna/.fa or .json ([{name, data}...])."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".json":
        with open(path) as fp:
            items = json.load(fp)
        return [Sequence.make(i + 1, x["name"], x["data"])
                for i, x in enumerate(items)]
    return [Sequence.make(i + 1, defline.split()[0] if defline else str(i + 1),
                          seq)
            for i, (defline, seq) in enumerate(read_fasta(path))]
