"""Hit segmentation over a parsed match list + query-interval mapping.

Parity: snap/deciphon_snap/hit.py (HitList.make) and query_interval.py
(QueryIntervalBuilder) — a hit is a maximal run of core (M/I/D) states;
its query interval accumulates emitted sizes with the window/hit offset.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..intervals import PyInterval
from .match import Match, MatchList

__all__ = ["Hit", "hits_of", "QueryIntervalBuilder"]


class QueryIntervalBuilder:
    def __init__(self, match_list: MatchList, offset: int):
        self._offsets = []
        for x in match_list:
            self._offsets.append(offset)
            offset += x.query_size
        self._offsets.append(offset)

    def make(self, match_interval: PyInterval) -> PyInterval:
        return PyInterval(start=self._offsets[match_interval.start],
                          stop=self._offsets[match_interval.stop])


@dataclass
class Hit:
    id: int
    match_interval: PyInterval  # indices into the match list
    interval: PyInterval | None = None  # query-space nucleotide interval
    match_list: MatchList | None = None

    @property
    def matches(self) -> list[Match]:
        assert self.interval is not None and self.match_list is not None
        out = []
        offset = self.interval.start
        for x in self.match_list[self.match_interval.slice]:
            m = Match(query=x.query, state=x.state, codon=x.codon,
                      amino=x.amino, position=offset)
            if m.is_match_state or m.is_insert_state:
                offset += m.query_size
            out.append(m)
        return out


def hits_of(match_list: MatchList) -> list[Hit]:
    """Segment a match list into maximal core-state runs
    (snap/deciphon_snap/hit.py:84-108 semantics: a trailing run that
    reaches the end of the list without a non-core closer is dropped,
    which cannot happen for well-formed products ending in E/C/T)."""
    hits: list[Hit] = []
    start = None
    for i, x in enumerate(match_list):
        if start is None and x.is_core_state:
            start = i
        elif start is not None and not x.is_core_state:
            hits.append(Hit(id=len(hits),
                            match_interval=PyInterval(start=start, stop=i)))
            start = None
    return hits
