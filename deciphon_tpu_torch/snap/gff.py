"""GFF3 export (parity: snap/deciphon_snap/gff.py)."""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["GFFItem", "GFFList"]


@dataclass
class GFFItem:
    seqid: str
    source: str
    type: str
    start: int
    end: int
    score: float
    strand: str
    phase: str
    attributes: str

    def format(self) -> str:
        score = f"{self.score:.2g}"
        return (f"{self.seqid}\t{self.source}\t{self.type}\t{self.start}\t"
                f"{self.end}\t{score}\t{self.strand}\t{self.phase}\t"
                f"{self.attributes}")


@dataclass
class GFFList:
    root: list[GFFItem] = field(default_factory=list)

    def __len__(self):
        return len(self.root)

    def __iter__(self):
        return iter(self.root)

    def __getitem__(self, i):
        return self.root[i]

    def format(self) -> str:
        lines = ["##gff-version 3"]
        for i, x in enumerate(self.root):
            item = GFFItem(**{**x.__dict__,
                              "attributes": x.attributes + f";ID={i + 1}"})
            lines.append(item.format())
        return "\n".join(lines) + "\n"
