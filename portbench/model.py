"""A configuration's profile database, drawn from the seed.

A configuration file (configs/<name>.json) fixes the database's shape: its
core sizes, as a list or a rule over a number of profiles, and the press
(genetic code, epsilon).
`draw` makes every profile's HMM parameters from `--seed` in a few
vectorised calls: per profile a null amino distribution, per node the
match amino log-probabilities and the transition log-probabilities.  Both
sides press the same arrays: the program with its own `press_profile`,
the reference with its frozen copy (reference/press.py).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist

import numpy as np

from .reference.gencode import get_gencode
from .reference.press import T_DD, T_MD, HMMParams, press_profile

ROOT = Path(__file__).resolve().parent


def load_config(file: str) -> dict:
    """A configuration file, by its path relative to the repository."""
    return json.loads((ROOT.parent / file).read_text())


def core_sizes(cfg: dict) -> list[int]:
    """The database's core sizes: `core_sizes` as a list, or a rule
    {"rule": "lognormal", "median", "sigma"} over `profiles` profiles: the
    count's evenly spaced quantiles of a log-normal, K_i = round(median x
    exp(sigma x z_i)), z_i the standard normal's (i + 1/2) / count
    quantile, in ascending order."""
    ks = cfg["core_sizes"]
    if isinstance(ks, list):
        return [int(k) for k in ks]
    if ks["rule"] != "lognormal":
        raise ValueError(f"unknown core-size rule {ks['rule']!r}")
    n, med, sig = int(cfg["profiles"]), float(ks["median"]), float(ks["sigma"])
    z = NormalDist()
    return [max(1, int(round(med * math.exp(sig * z.inv_cdf((i + 0.5) / n)))))
            for i in range(n)]


def accession(i: int) -> str:
    return f"PB{i:05d}"


def _log_normalised(lg: np.ndarray) -> np.ndarray:
    """Rows of log weights (-inf for none) as log-probabilities."""
    m = lg.max(1, keepdims=True)
    return lg - (np.log(np.exp(lg - m).sum(1, keepdims=True)) + m)


def draw(cfg: dict, seed: int) -> list[HMMParams]:
    """Every profile's parameters from `seed`, in four vectorised draws,
    by the rule of deciphon_tpu_torch/profile.py's `sample_profile`
    (copied): every probability vector is uniform random weights,
    normalised -- a null amino distribution a profile, a match amino
    distribution a node, and a node's seven transitions normalised
    together (the BEGIN line has no DD, the last node no MD or DD)."""
    ks = core_sizes(cfg)
    rng = np.random.default_rng(seed)
    n, P = sum(ks), len(ks)
    nulls = _log_normalised(np.log(rng.random((P, 20))))
    match = _log_normalised(np.log(rng.random((n, 20)))).astype(np.float32)
    w = np.log(rng.random((n + P, 7)))
    ends = np.cumsum([k + 1 for k in ks])
    w[ends - 1 - np.asarray(ks), T_DD] = -np.inf  # row 0: no delete yet
    w[ends - 1, T_MD] = -np.inf  # row K: nothing to delete into
    w[ends - 1, T_DD] = -np.inf
    trans = _log_normalised(w).astype(np.float32)
    out, a, r = [], 0, 0
    for i, K in enumerate(ks):
        out.append(HMMParams(accession(i), match[a:a + K],
                             trans[r:r + K + 1], nulls[i]))
        a += K
        r += K + 1
    return out


def press_reference(cfg: dict, hmms: list[HMMParams], which) -> dict:
    """The reference's own presses of the profiles `which`."""
    return {i: press_profile(hmms[i], cfg["gencode"], cfg["epsilon"])
            for i in which}


def press_program(cfg: dict, hmms: list[HMMParams]) -> list:
    """The program's presses: its HMMProfile and press_profile."""
    from deciphon_tpu_torch.hmmfile import HMMProfile
    from deciphon_tpu_torch.profile import press_profile as port_press

    out = []
    for h in hmms:
        K = h.length
        hmm = HMMProfile(name=h.name, accession=h.name, length=K,
                         consensus="-" * K, match_lprobs=h.match_lprobs,
                         trans=h.trans)
        out.append(port_press(hmm, cfg["gencode"], cfg["epsilon"],
                              null_amino_lprobs=h.null_lprobs))
    return out


def argmax_codons(cfg: dict, h: HMMParams, a: int, b: int) -> np.ndarray:
    """Nodes [a, b)'s most likely codons (0..63), from the parameters: the
    amino with the largest log-odds per codon coding it, then that amino's
    first codon -- the codon the press ranks first."""
    gc = get_gencode(cfg["gencode"])
    idx = gc.amino_idx.astype(np.int64)
    ncod = np.bincount(idx[idx >= 0], minlength=20)
    lodds = (h.match_lprobs[a:b].astype(np.float64)
             - np.asarray(h.null_lprobs, np.float64)[None, :])
    codon_score = np.where(idx >= 0, lodds[:, np.maximum(idx, 0)]
                           - np.log(np.maximum(ncod, 1))[np.maximum(idx, 0)],
                           -np.inf)
    return codon_score.argmax(1)
