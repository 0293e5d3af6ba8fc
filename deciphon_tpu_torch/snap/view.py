"""Alignment rendering for `see` (parity target: snap/deciphon_snap/view.py).

Renders Deciphon and HMMER alignments side by side, associating HMMER
alignment columns with Deciphon match steps by amino position — the
reference's assoc_steps algorithm (snap/deciphon_snap/view.py:72-101).
Where the reference re-parses the C library's printed "Alignments for
each domain" text (via hmmer_tables.read_query), we build the HMMER
steps directly from the parsed .h3r alidisplay rows (hmmer/h3result.py),
no text round-trip.

Per product, blocks of up to 96 columns with rows:

  CS      profile consensus structure (when present)
  profile aligned profile consensus  [hmm coords]
          midline (match/+/space)
  amino   Deciphon's decoded amino per step  [amino coords]
  query   emitted nucleotide fragments, one row per fragment offset
          [query-sequence coords]
  PP      posterior probability per column

Products without an .h3r blob fall back to the Deciphon-only view.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..hmmer.h3result import H3Result
from .match import Match
from .prod import Prod, ProdList

__all__ = ["view_alignments", "view_alignment"]


@dataclass
class HmmerStep:
    hmm_pos: int  # 1-based profile coordinate
    amino_pos: int  # 0-based position in the submitted amino sequence
    cs: str | None  # consensus structure char
    model: str  # profile consensus char
    match: str  # midline char
    amino: str  # aligned query char
    score: str  # posterior probability char


def make_deciphon_steps(prod: Prod) -> list[tuple[int, Match]]:
    """Amino-emitting steps, keyed by amino ordinal
    (reference make_deciphon_steps)."""
    return list(enumerate(m for m in prod.matches if m.amino))


def make_hmmer_steps(h3r: H3Result) -> list[tuple[int, HmmerStep]]:
    """HMMER alignment columns keyed by 0-based amino position, straight
    from the alidisplay rows (reference make_hmmer_steps semantics:
    hmm position advances on non-'.' model columns, amino position on
    non-'-' query columns)."""
    steps: list[tuple[int, HmmerStep]] = []
    for hit in h3r.hits:
        for dom in hit.domains:
            ad = dom.ad
            hmm_pos = ad.hmmfrom - 1
            amino_pos = ad.sqfrom - 2  # 0-based, pre-incremented below
            for i in range(len(ad.aseq)):
                if ad.model[i] != ".":
                    hmm_pos += 1
                if ad.aseq[i] != "-":
                    amino_pos += 1
                steps.append((amino_pos, HmmerStep(
                    hmm_pos=hmm_pos,
                    amino_pos=amino_pos,
                    cs=ad.csline[i] if ad.csline else None,
                    model=ad.model[i],
                    match=ad.mline[i],
                    amino=ad.aseq[i],
                    score=ad.ppline[i] if ad.ppline else " ",
                )))
    return steps


def assoc_steps(deci: list[tuple[int, Match]],
                hmmer: list[tuple[int, HmmerStep]]):
    """Merge-join the two step streams on amino position
    (reference assoc_steps, view.py:72-101)."""
    out: list[tuple[Match | None, HmmerStep | None]] = []
    di = hi = 0
    while di < len(deci) and hi < len(hmmer):
        dpos, hpos = deci[di][0], hmmer[hi][0]
        if dpos < hpos:
            out.append((deci[di][1], None))
            di += 1
        elif hpos < dpos:
            out.append((None, hmmer[hi][1]))
            hi += 1
        else:
            out.append((deci[di][1], hmmer[hi][1]))
            di += 1
            hi += 1
    out.extend((d[1], None) for d in deci[di:])
    out.extend((None, h[1]) for h in hmmer[hi:])
    return out


def _tabulate(rows: list[list], aligns=("right", "right", "left", "left")):
    cols = max(len(r) for r in rows)
    widths = [0] * cols
    cells = [[("" if c is None else str(c)) for c in r] + [""] * (cols - len(r))
             for r in rows]
    for r in cells:
        for j, c in enumerate(r):
            widths[j] = max(widths[j], len(c))
    lines = []
    for r in cells:
        parts = []
        for j, c in enumerate(r):
            if aligns[j % len(aligns)] == "right":
                parts.append(c.rjust(widths[j]))
            else:
                parts.append(c.ljust(widths[j]))
        lines.append(("  ".join(parts)).rstrip())
    return "\n".join(lines)


def view_alignment(prod: Prod, width: int = 96) -> str:
    h3r = prod.h3result
    if h3r is None or not h3r.hits or not h3r.hits[0].domains:
        return _view_deciphon_only(prod, width)

    deci = make_deciphon_steps(prod)
    hmmer = make_hmmer_steps(h3r)
    steps = assoc_steps(deci, hmmer)

    ad0 = h3r.hits[0].domains[0].ad
    profile = prod.profile
    query_name = ad0.sqname or str(prod.seq_id)
    has_cs = any(h is not None and h.cs is not None for _, h in steps)

    # Column-wise rows over hmmer-visible steps; deciphon-only steps are
    # skipped in the rendered table exactly like the reference (its grab_*
    # helpers emit "" for hmmer=None steps).
    cs_row, model_row, match_row, amino_row, score_row = [], [], [], [], []
    qrows = [[] for _ in range(5)]
    hmm_pos, amino_pos, query_pos = [], [], []
    curr_qpos = 0
    for d, h in steps:
        if h is None:
            continue
        if d is not None:
            curr_qpos = d.position
            query_pos.append(curr_qpos)
            curr_qpos += len(d.query)
        else:
            query_pos.append(curr_qpos)
        cs_row.append(h.cs or "")
        model_row.append(h.model)
        match_row.append(h.match)
        score_row.append(h.score)
        amino_row.append(d.amino if d is not None else "-")
        for i in range(5):
            if d is None:
                qrows[i].append("-")
            else:
                qrows[i].append(d.query[i] if len(d.query) > i else ".")
        hmm_pos.append(h.hmm_pos)
        amino_pos.append(h.amino_pos)

    txt = "Alignments for each domain:\n"
    txt += (f"== domain 1  score: {h3r.hits[0].domains[0].bitscore:.1f} "
            f"bits\n")
    table: list[list] = []
    n = len(model_row)
    for i in range(0, n, width):
        sl = slice(i, min(i + width, n))
        rows: list[list] = []
        if has_cs:
            rows.append([None, None, "".join(cs_row[sl]), "CS"])
        rows += [
            [profile, hmm_pos[sl.start], "".join(model_row[sl]),
             hmm_pos[sl.stop - 1]],
            [None, None, "".join(match_row[sl]), None],
            [None, amino_pos[sl.start] + 1, "".join(amino_row[sl]),
             amino_pos[sl.stop - 1] + 1],
            [query_name, query_pos[sl.start] + 1, "".join(qrows[0][sl]),
             query_pos[sl.stop - 1] + 1],
        ]
        for r in range(1, 5):
            body = "".join(qrows[r][sl])
            if body.strip("."):
                rows.append([None, None, body, None])
        rows.append([None, None, "".join(score_row[sl]), "PP"])
        table += rows + [[None, None, None, None]]
    txt += _tabulate(table) + "\n"
    return txt


def _view_deciphon_only(prod: Prod, width: int = 96) -> str:
    out = []
    for hit in prod.hits:
        matches = hit.matches
        cols = []
        for m in matches:
            q = m.query or "-"
            a = m.amino or "-"
            s = m.state
            w = max(len(q), len(a), len(s))
            cols.append((s.ljust(w), a.ljust(w), q.ljust(w)))

        header = (f"{prod.profile} hit {hit.id} "
                  f"query {hit.interval.r.start}..{hit.interval.r.stop} "
                  f"lrt {prod.lrt:.1f} evalue {prod.evalue:.2g}")
        out.append(header)
        block_s, block_a, block_q, wsum = [], [], [], 0
        for s, a, q in cols:
            if wsum + len(s) + 1 > width and block_s:
                out.extend(_emit_block(block_s, block_a, block_q))
                block_s, block_a, block_q, wsum = [], [], [], 0
            block_s.append(s)
            block_a.append(a)
            block_q.append(q)
            wsum += len(s) + 1
        if block_s:
            out.extend(_emit_block(block_s, block_a, block_q))
    return "\n".join(out)


def _emit_block(ss, aa, qq):
    return ["state " + " ".join(ss), "amino " + " ".join(aa),
            "query " + " ".join(qq), ""]


def view_alignments(prods: ProdList, width: int = 96) -> str:
    return "\n".join(view_alignment(p, width) for p in prods)
