"""FASTA export (parity: snap/deciphon_snap/fasta.py, without the
fasta_reader dependency)."""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["FASTAItem", "FASTAList"]


@dataclass
class FASTAItem:
    defline: str
    sequence: str


@dataclass
class FASTAList:
    root: list[FASTAItem] = field(default_factory=list)

    def __len__(self):
        return len(self.root)

    def __iter__(self):
        return iter(self.root)

    def __getitem__(self, i):
        return self.root[i]

    def format(self, ncols: int = 60) -> str:
        out = []
        for x in self.root:
            out.append(f">{x.defline}")
            seq = x.sequence
            for i in range(0, max(len(seq), 1), ncols):
                out.append(seq[i:i + ncols])
        return "\n".join(out) + "\n"
