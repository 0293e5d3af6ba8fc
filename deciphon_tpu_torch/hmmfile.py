"""HMMER3 ASCII profile (.hmm) parser.

Replaces the reference's `hmmer-reader` (hmr) dependency
(c-core/hmm_reader.c:19-70 consumes hmr's per-node output).

Format notes (HMMER3/f, public format from the HMMER3 documentation):
  - header key/value lines until the ``HMM`` symbol-header line,
  - a transition-order header line ``m->m m->i m->d i->m i->i d->m d->d``,
  - an optional ``COMPO`` line,
  - node 0: insert-emission line + transition line (only transitions used),
  - nodes 1..K: match line (idx, 20 scores, MAP, CONS, RF, MM, CS),
    insert line, transition line,
  - ``//`` terminator.
Stored values are negated natural logs of probabilities; ``*`` means
probability zero.  Like hmr, we hand out *log-probabilities* (so we negate
file values; ``*`` -> -inf).

The port's own copy of deciphon_tpu/hmmfile.py, kept equal in behaviour
(tests/test_torch_copies.py compares the two).
"""

from __future__ import annotations

import io
import math
from dataclasses import dataclass, field

import numpy as np

NUM_AMINO = 20
NUM_TRANS = 7  # MM MI MD IM II DM DD (c-core/trans.h)

# Indices into the transitions array, matching c-core/trans.h field order.
T_MM, T_MI, T_MD, T_IM, T_II, T_DM, T_DD = range(7)


class HMMFileError(ValueError):
    pass


@dataclass
class HMMProfile:
    """One profile parsed from a .hmm file (log-prob convention)."""

    name: str = ""
    accession: str = ""
    description: str = ""
    length: int = 0
    alphabet: str = "amino"
    consensus: str = ""
    # match_lprobs[k, a]: log-prob of amino a at match state k+1 (K rows)
    match_lprobs: np.ndarray = field(default_factory=lambda: np.zeros((0, NUM_AMINO), np.float32))
    # trans[j]: transitions *leaving node j* (j = 0..K); trans[0] is the
    # BEGIN-node line.  Log-probs; column order MM MI MD IM II DM DD.
    trans: np.ndarray = field(default_factory=lambda: np.zeros((0, NUM_TRANS), np.float32))
    ga: tuple[float, float] | None = None
    compo: np.ndarray | None = None
    # insert emissions (log-probs) per node 0..K (row 0 = BEGIN node)
    insert_lprobs: np.ndarray | None = None
    # Gumbel/exponential tail calibration: {"MSV"|"VITERBI"|"FORWARD":
    # (mu/tau, lambda)} from the STATS LOCAL lines
    stats: dict = field(default_factory=dict)

    @property
    def has_ga(self) -> bool:
        return self.ga is not None


def _parse_score(tok: str) -> float:
    if tok == "*":
        return -math.inf
    return -float(tok)


def _parse_scores(tokens: list[str]) -> np.ndarray:
    return np.array([_parse_score(t) for t in tokens], dtype=np.float32)


def read_hmm(path_or_file) -> list[HMMProfile]:
    """Parse every profile in a .hmm file."""
    if hasattr(path_or_file, "read"):
        return list(iter_hmm(path_or_file))
    with open(path_or_file, "rt") as fp:
        return list(iter_hmm(fp))


def iter_hmm(fp: io.TextIOBase):
    """Yield HMMProfile objects one at a time (streaming)."""
    line = fp.readline()
    while line:
        line = line.rstrip("\n")
        if not line.strip():
            line = fp.readline()
            continue
        if not line.startswith("HMMER3/f"):
            raise HMMFileError(
                f"expected 'HMMER3/f' profile header, got {line[:40]!r}"
            )
        yield _read_one(fp)
        line = fp.readline()


def _read_one(fp) -> HMMProfile:
    p = HMMProfile()
    # Header section.
    while True:
        line = fp.readline()
        if not line:
            raise HMMFileError("unexpected EOF in profile header")
        tokens = line.split()
        if not tokens:
            continue
        key = tokens[0]
        if key == "HMM":
            break
        if key == "NAME":
            p.name = line[5:].strip()
        elif key == "ACC":
            p.accession = line[5:].strip()
        elif key == "DESC":
            p.description = line[5:].strip()
        elif key == "LENG":
            p.length = int(tokens[1])
        elif key == "ALPH":
            p.alphabet = tokens[1].lower()
        elif key == "GA":
            vals = [t.rstrip(";") for t in tokens[1:3]]
            p.ga = (float(vals[0]), float(vals[1]))
        elif key == "STATS" and len(tokens) >= 5 and tokens[1] == "LOCAL":
            p.stats[tokens[2]] = (float(tokens[3]), float(tokens[4]))
        # other keys (DATE, NSEQ, EFFN, CKSUM, ...) are not needed
    if p.alphabet != "amino":
        raise HMMFileError(f"only amino profiles supported, got {p.alphabet!r}")
    if p.length <= 0:
        raise HMMFileError("missing or invalid LENG")

    fp.readline()  # the 'm->m m->i ...' transition-order header line

    trans_rows: list[np.ndarray] = []
    match_rows: list[np.ndarray] = []
    consensus: list[str] = []

    insert_rows: list[np.ndarray] = []

    # Node 0 (BEGIN): optional COMPO line, insert line, transition line.
    line = fp.readline()
    tokens = line.split()
    if tokens and tokens[0] == "COMPO":
        p.compo = _parse_scores(tokens[1 : 1 + NUM_AMINO])
        line = fp.readline()  # node-0 insert emissions
    insert_rows.append(_parse_scores(line.split()[:NUM_AMINO]))
    trans_line = fp.readline()
    trans_rows.append(_parse_scores(trans_line.split()[:NUM_TRANS]))

    # Nodes 1..K.
    for k in range(1, p.length + 1):
        match_line = fp.readline()
        tokens = match_line.split()
        if not tokens:
            raise HMMFileError(f"unexpected EOF at node {k}")
        if int(tokens[0]) != k:
            raise HMMFileError(f"node index mismatch: expected {k}, got {tokens[0]}")
        match_rows.append(_parse_scores(tokens[1 : 1 + NUM_AMINO]))
        # columns after scores: MAP CONS RF MM CS (presence per header flags;
        # hmr reads CONS as the 2nd excess column; we take token 21+1 if there)
        excess = tokens[1 + NUM_AMINO :]
        consensus.append(excess[1] if len(excess) > 1 else "-")
        insert_rows.append(_parse_scores(fp.readline().split()[:NUM_AMINO]))
        trans_rows.append(_parse_scores(fp.readline().split()[:NUM_TRANS]))

    term = fp.readline()
    if not term.strip().startswith("//"):
        raise HMMFileError(f"expected '//' terminator, got {term[:20]!r}")

    p.match_lprobs = np.stack(match_rows).astype(np.float32)
    p.trans = np.stack(trans_rows).astype(np.float32)
    p.insert_lprobs = np.stack(insert_rows).astype(np.float32)
    p.consensus = "".join(consensus)
    return p


def count_profiles(path) -> int:
    """Count profiles by scanning for 'HMMER3/f' headers (press.c:107-125)."""
    n = 0
    with open(path, "rb") as fp:
        for line in fp:
            if line.startswith(b"HMMER3/f"):
                n += 1
    return n
