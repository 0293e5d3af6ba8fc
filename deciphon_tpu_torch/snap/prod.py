"""Product rows with hit/GFF/FASTA views (parity: snap/deciphon_snap/prod.py)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..intervals import PyInterval
from .fasta import FASTAItem, FASTAList
from .gff import GFFItem, GFFList
from .hit import Hit, QueryIntervalBuilder, hits_of
from .match import Match, MatchList

__all__ = ["Prod", "ProdList"]


@dataclass
class Prod:
    id: int
    seq_id: int
    window: int
    window_interval: PyInterval
    hit: int
    hit_interval: PyInterval
    profile: str
    abc: str
    lrt: float
    evalue: float
    match_list: MatchList
    h3result_blob: bytes | None = None

    @property
    def h3result(self):
        """Parsed HMMER result (hmmer/h3result.py), or None.

        Parity: snap/deciphon_snap/prod.py's H3Result attachment used by
        the hmmer views and the side-by-side alignment renderer."""
        if self.h3result_blob is None:
            return None
        from ..hmmer.h3result import H3Result
        try:
            return H3Result.from_blob(self.h3result_blob)
        except (ValueError, KeyError):
            return None

    @property
    def query_offset(self) -> int:
        """Sequence-space offset of the match list's first step."""
        return self.window_interval.start + self.hit_interval.start

    @property
    def hits(self) -> list[Hit]:
        qib = QueryIntervalBuilder(self.match_list, self.query_offset)
        hits = []
        for hit in hits_of(self.match_list):
            hit.interval = qib.make(hit.match_interval)
            hit.match_list = self.match_list
            hits.append(hit)
        return hits

    @property
    def matches(self) -> list[Match]:
        out = []
        offset = self.query_offset
        for x in self.match_list:
            out.append(Match(query=x.query, state=x.state, codon=x.codon,
                             amino=x.amino, position=offset))
            offset += x.query_size
        return out

    @property
    def gffs(self) -> GFFList:
        items = []
        for hit in self.hits:
            items.append(GFFItem(
                seqid=str(self.seq_id), source="deciphon", type="CDS",
                start=hit.interval.r.start, end=hit.interval.r.stop,
                score=self.evalue, strand="+", phase="0",
                attributes=f"Profile={self.profile};Alphabet={self.abc}"))
        return GFFList(items)

    @property
    def query(self) -> str:
        return self.match_list.query

    @property
    def codon(self) -> str:
        return self.match_list.codon

    @property
    def amino(self) -> str:
        return self.match_list.amino


@dataclass
class ProdList:
    root: list[Prod] = field(default_factory=list)

    def __len__(self):
        return len(self.root)

    def __iter__(self):
        return iter(self.root)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ProdList(self.root[i])
        return self.root[i]

    def gff_list(self) -> GFFList:
        return GFFList([g for p in self.root for g in p.gffs])

    def fasta_list(self, elem: str) -> FASTAList:
        """elem in {"query", "codon", "amino", "state"}."""
        items = []
        for p in self.root:
            seq = getattr(p.match_list, elem)
            items.append(FASTAItem(defline=str(p.seq_id), sequence=seq))
        return FASTAList(items)
