"""The comparison that decides `correct`.

After the window, a sample drawn from the seed over the batches that the
window served (`sample`): `check.reads` reads drawn uniformly from all
of them, each against its planted profile, `check.profiles` profiles
evenly spaced over the database and every profile the program wrote a
line for; and `check.lines` further lines the program wrote, drawn from
all served batches.  The reference (reference/scan.py) scans every pair
of the sample from its own presses; the program's lines of the same
pairs are read from the products.tsv that the timed path wrote for that
batch (a batch with no products.tsv has no lines).  Two numbers are
compared, each with the cell's limit (limits/<cell>.json):

  lrt_gap          the widest |LRT| gap of a line both sides wrote (the
                   program prints the LRT to 0.1, so a sound run reads
                   at most 0.05): phase 1's scores of the survivors;
  lines_differing  lines that one side wrote and the other did not, or
                   whose window, hit bounds or steps (path, fragments,
                   codons, aminos) differ: the LRT decision, phase 2's
                   path and traceback, and the decode.

A pair one of whose windows the reference scores within `NEAR` of the
LRT's threshold 0 is left out: there f32 rounding, which the tiers of
the program may group differently, decides whether a line is written.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .model import press_reference
from .reference.scan import Line, scan_pairs

ROOT = Path(__file__).resolve().parent
NUMBERS = ("lrt_gap", "lines_differing")
NEAR = 0.01
SEQ_BASE = 1000  # sequence id of read i of served batch b: b x SEQ_BASE + i


def load_limits(cell: str) -> dict:
    return json.loads((ROOT / "limits" / f"{cell}.json").read_text())


def parse_products(text: str, seq_base: int = 0) -> list[Line]:
    """products.tsv's rows (header skipped) as Lines; sequence ids are
    offset by `seq_base`."""
    out = []
    for row in text.splitlines()[1:]:
        c = row.split("\t")
        out.append(Line(int(c[0]) + seq_base, int(c[1]), int(c[2]),
                        int(c[3]), int(c[5]), int(c[6]), c[7], float(c[9]),
                        c[11]))
    return out


def read_products(path) -> str:
    """A batch's products.tsv, or nothing where the run wrote none."""
    try:
        return Path(path).read_text()
    except FileNotFoundError:
        return ""


def sample(traffic: dict, served, products: list[str], hmms, seed: int):
    """The checked (batch, read, profile) triples, drawn from the seed over
    the batches the window served (`served`, their products.tsv texts
    `products`): `check.reads` reads, each against its planted profile,
    `check.profiles` profiles evenly spaced over the database from a
    random offset and every profile the program wrote a line of it for;
    and `check.lines` more of the lines the program wrote."""
    rng = np.random.default_rng([seed, 2])
    chk = traffic["check"]
    index = {h.name: p for p, h in enumerate(hmms)}
    P = len(hmms)

    def pick(xs, n):
        n = min(n, len(xs))
        return [xs[i] for i in sorted(rng.choice(len(xs), n, replace=False))]

    wrote = sorted({(b, ln.sequence, index[ln.profile])
                    for b, text in enumerate(products)
                    for ln in parse_products(text)})
    reads = pick([(b, i) for b, bt in enumerate(served)
                  for i in range(len(bt.reads))], int(chk["reads"]))
    q = int(chk["profiles"])
    out = set()
    for b, i in reads:
        u = rng.random()
        out |= {(b, i, int((j + u) * P / q)) for j in range(q)}
        if served[b].planted[i] is not None:
            out.add((b, i, served[b].planted[i][0]))
    picked = set(reads)
    out |= {t for t in wrote if t[:2] in picked}
    out |= set(pick([t for t in wrote if t not in out], int(chk["lines"])))
    return sorted(out)


def compare(prog: list[Line], ref: list[Line], near=()) -> dict:
    """The two numbers of the comparison, and the lines each side wrote;
    the pairs (sequence, profile) in `near` are left out."""
    a = {ln.key: ln for ln in prog if (ln.sequence, ln.profile) not in near}
    b = {ln.key: ln for ln in ref if (ln.sequence, ln.profile) not in near}
    gap, differ = 0.0, len(a.keys() ^ b.keys())
    for k in a.keys() & b.keys():
        x, y = a[k], b[k]
        gap = max(gap, abs(x.lrt - y.lrt))
        if ((x.window_start, x.window_stop, x.hit_start, x.hit_stop, x.steps)
                != (y.window_start, y.window_stop, y.hit_start, y.hit_stop,
                    y.steps)):
            differ += 1
    return {"lrt_gap": gap, "lines_differing": differ,
            "lines_program": len(a), "lines_reference": len(b),
            "pairs_near": len(near)}


def reference_lines(cfg: dict, hmms, served, triples, device,
                    dtype=None, near=None) -> list[Line]:
    """The reference's lines of the checked pairs (sequence id = batch x
    SEQ_BASE + read index); `near`, if given, gets the pairs whose LRT
    came within NEAR of its threshold."""
    import torch

    presses = press_reference(cfg, hmms, sorted({p for _, _, p in triples}))
    keys = sorted({(b, i) for b, i, _ in triples})
    at = {k: j for j, k in enumerate(keys)}
    rs = [(b * SEQ_BASE + i, served[b].reads[i]) for b, i in keys]
    pairs = [(p, at[(b, i)]) for b, i, p in triples]
    return scan_pairs(presses, rs, pairs, multi_hits=cfg["multi_hits"],
                      hmmer3_compat=cfg["hmmer3_compat"], device=device,
                      dtype=dtype or torch.float32, near=near, near_lrt=NEAR)


def program_lines(products: list[str], triples, hmms) -> list[Line]:
    """The program's lines of the checked pairs, from each batch's
    products.tsv."""
    want = {(b * SEQ_BASE + i, hmms[p].name) for b, i, p in triples}
    out = []
    for b in sorted({b for b, _, _ in triples}):
        for ln in parse_products(products[b], b * SEQ_BASE):
            if (ln.sequence, ln.profile) in want:
                out.append(ln)
    return out


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)
