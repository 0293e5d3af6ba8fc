"""The one generator of read batches, driven by a traffic file.

A traffic file (traffic/<name>.json) gives a batch as groups of reads:
{"length": nt, "count": n, "planted": m} -- n reads of `length` nt, m of
which carry a planted stretch of a database profile: the most likely
codons of nodes [a, a + n_nodes) (n_nodes = min(K, plant_fill x length /
3)), with substitutions, insertions and deletions each at noise / 3 a
base, at a random offset in uniform random bases.  A batch's reads are
shuffled, so a planted read may sit anywhere in it.  `check` says what
the reference scans after the window (check.py).

A run serves a stream of fresh batches: batch j is drawn from the seed's
stream (seed, 1, j) alone, so the window never serves a batch twice and
the check can draw any served batch again; the warm-up batch comes from
(seed, 0).  Every batch has the same read lengths, the same number of
planted reads and the same spread of planted profile sizes (evenly
spaced over the database's order from a random offset); which profiles,
their stretches, the reads' order and the bases differ.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .model import argmax_codons

ROOT = Path(__file__).resolve().parent
BASES = np.frombuffer(b"ACGT", np.uint8)


def load_traffic(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


@dataclass
class Batch:
    """One batch: reads as strings, and per read its planted
    (profile, first node, nodes) or None."""

    reads: list[str]
    planted: list = field(default_factory=list)

    @property
    def nt(self) -> int:
        return sum(len(r) for r in self.reads)


def mutate(rng: np.random.Generator, codes: np.ndarray,
           rate: float) -> np.ndarray:
    """Per base, with probability rate / 3 each: a substitution, an
    inserted random base after it, or a deletion."""
    u = rng.random(len(codes))
    out = codes.copy()
    sub = u < rate / 3
    out[sub] = rng.integers(0, 4, int(sub.sum()))
    ins = (u >= rate / 3) & (u < 2 * rate / 3)
    keep = ~((u >= 2 * rate / 3) & (u < rate))
    reps = keep.astype(np.int64) + ins
    res = np.repeat(out, reps)
    # the second copy of an inserting base becomes a random base
    ends = np.cumsum(reps) - 1
    res[ends[ins]] = rng.integers(0, 4, int(ins.sum()))
    return res


def codon_bases(codons: np.ndarray) -> np.ndarray:
    """Codon indices (ACGT order) -> their bases, 3 a codon."""
    return np.stack([codons >> 4, (codons >> 2) & 3, codons & 3], 1).ravel()


def make_batch(cfg: dict, hmms, traffic: dict, key) -> Batch:
    """The batch that numpy's generator seeded with `key` draws."""
    rng = np.random.default_rng(key)
    fill = float(traffic["plant_fill"])
    noise = float(traffic["noise"])
    n = sum(int(g.get("planted", 0)) for g in traffic["batch"])
    # the planted profiles: evenly spaced over the database's order (its
    # core sizes), from one random offset, in a random order
    u = rng.random()
    plant = iter(rng.permutation([int((j + u) * len(hmms) / n)
                                  for j in range(n)]))
    reads, planted = [], []
    for g in traffic["batch"]:
        L, count = int(g["length"]), int(g["count"])
        marked = rng.permutation(count) < int(g.get("planted", 0))
        for j in range(count):
            seq = rng.integers(0, 4, L)
            mark = None
            if marked[j]:
                p = int(next(plant))
                K = hmms[p].length
                nodes = min(K, int(fill * L / 3))
                a = int(rng.integers(0, K - nodes + 1))
                dom = mutate(rng, codon_bases(
                    argmax_codons(cfg, hmms[p], a, a + nodes)), noise)
                dom = dom[:L]
                off = int(rng.integers(0, L - len(dom) + 1))
                seq[off:off + len(dom)] = dom
                mark = (p, a, nodes)
            reads.append(BASES[seq].tobytes().decode())
            planted.append(mark)
    order = rng.permutation(len(reads))
    return Batch([reads[i] for i in order], [planted[i] for i in order])


def batch(cfg: dict, hmms, traffic: dict, seed: int, j: int) -> Batch:
    """Batch j (from 0) of the stream that `seed` draws."""
    return make_batch(cfg, hmms, traffic, [seed, 1, j])


def warmup_batch(cfg: dict, hmms, traffic: dict, seed: int) -> Batch:
    """The batch that warms the scanner up before the window."""
    return make_batch(cfg, hmms, traffic, [seed, 0])
