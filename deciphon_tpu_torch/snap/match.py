"""Match-string parsing (parity: snap/deciphon_snap/match.py).

A product row's ``match`` column is ``;``-joined steps of
``query,STATE,codon,amino`` (codon/amino empty for mute states).
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Match", "MatchList"]


@dataclass(frozen=True)
class Match:
    query: str
    state: str
    codon: str
    amino: str
    position: int = -1  # query-space offset of this step (set by callers)

    @classmethod
    def from_string(cls, raw: str) -> "Match":
        q, s, c, a = raw.split(",")
        return cls(query=q, state=s, codon=c, amino=a)

    @property
    def raw(self) -> str:
        return f"{self.query},{self.state},{self.codon},{self.amino}"

    @property
    def query_size(self) -> int:
        return len(self.query)

    @property
    def state_symbol(self) -> str:
        return self.state[0]

    @property
    def is_match_state(self) -> bool:
        return self.state_symbol == "M"

    @property
    def is_insert_state(self) -> bool:
        return self.state_symbol == "I"

    @property
    def is_delete_state(self) -> bool:
        return self.state_symbol == "D"

    @property
    def is_core_state(self) -> bool:
        return self.state_symbol in "MID"

    @property
    def is_mute(self) -> bool:
        return self.amino == ""

    def __str__(self):
        q = self.query or "∅"
        c = self.codon or "∅"
        a = self.amino or "∅"
        return f"({q},{self.state},{c},{a})"


@dataclass
class MatchList:
    root: list[Match] = field(default_factory=list)

    @classmethod
    def from_string(cls, raw: str) -> "MatchList":
        if not raw:
            return cls([])
        return cls([Match.from_string(x) for x in raw.split(";")])

    def __len__(self):
        return len(self.root)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return MatchList(self.root[i])
        return self.root[i]

    def __iter__(self):
        return iter(self.root)

    def __str__(self):
        return " ".join(str(x) for x in self.root)

    @property
    def query(self) -> str:
        return "".join(x.query for x in self.root)

    @property
    def state(self) -> str:
        return "".join(x.state for x in self.root)

    @property
    def codon(self) -> str:
        return "".join(x.codon for x in self.root)

    @property
    def amino(self) -> str:
        return "".join(x.amino for x in self.root)
