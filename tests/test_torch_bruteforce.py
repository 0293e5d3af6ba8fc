"""The port's plain Viterbi (`ops/viterbi_torch.py` `viterbi` and
`viterbi_null`) against the port's exhaustive path enumeration
(`ops/bruteforce.py`, a copy of the reference's oracle), on the cases of
tests/test_viterbi.py (K <= 3, L <= 8): the best path cost and the null
path cost within the reference's cross-engine tolerance (rtol 2e-5, atol
2e-5).  The port's oracle also gives the reference oracle's costs, bit
for bit, on the reference's costs of the same profile.
"""

import numpy as np
import pytest
import torch

from deciphon_tpu.ops import bruteforce as r_bruteforce
from deciphon_tpu.ops.costs import build_costs as r_build_costs
from deciphon_tpu.profile import sample_profile as r_sample_profile
from deciphon_tpu_torch.ops import bruteforce
from deciphon_tpu_torch.ops.costs import build_costs
from deciphon_tpu_torch.ops.viterbi_torch import viterbi, viterbi_null
from deciphon_tpu_torch.profile import sample_profile
from deciphon_tpu_torch.scan.sequence import frag_codes_ending

torch.set_num_threads(1)

CASES = [
    # (seed, K, L, eps, multi_hits, hmmer3_compat), tests/test_viterbi.py
    (1, 2, 4, 0.1, True, False),
    (2, 2, 6, 0.1, False, False),
    (3, 3, 5, 0.01, True, True),
    (4, 2, 7, 0.5, True, False),
    (5, 3, 7, 0.1, False, True),
    # one window of 8 nt, the longest the oracle enumerates quickly
    (6, 2, 8, 0.1, True, False),
]


def case(seed, K, L, eps, mh, h3c, salt):
    prof = sample_profile(seed, K, epsilon=eps)
    seq = np.random.default_rng(seed + salt).integers(
        0, 4, size=L).astype(np.int8)
    return prof, seq, build_costs(prof, mh, h3c, window_len=L)


def t(a):
    return torch.tensor(np.array(a))


@pytest.mark.parametrize("seed,K,L,eps,mh,h3c", CASES)
@pytest.mark.parametrize("model", ["alt", "null"])
def test_plain_viterbi_matches_bruteforce(seed, K, L, eps, mh, h3c, model):
    salt = 100 if model == "alt" else 200
    _, seq, costs = case(seed, K, L, eps, mh, h3c, salt)
    codes = t(frag_codes_ending(seq))
    if model == "alt":
        want = bruteforce.best_path_cost(costs, seq)
        got = float(viterbi(t(costs.core), t(costs.match), t(costs.null),
                            t(costs.background), t(costs.xt), codes, L))
    else:
        want = bruteforce.best_null_cost(costs, seq)
        got = float(viterbi_null(t(costs.null), costs.xt[0], codes, L))
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    r_costs = r_build_costs(r_sample_profile(seed, K, epsilon=eps), mh, h3c,
                            window_len=L)
    fn = "best_path_cost" if model == "alt" else "best_null_cost"
    assert getattr(bruteforce, fn)(costs, seq) == \
        getattr(r_bruteforce, fn)(r_costs, seq)
