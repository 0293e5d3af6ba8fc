"""Port parity: the B1 score kernel's plain version against the Pallas
kernel (interpret mode, bit for bit) and the lax.scan engine (within the
reference's cross-engine tolerance, tests/test_pallas.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deciphon_tpu.ops import viterbi_pallas as vp
from deciphon_tpu.ops.costs import build_costs
from deciphon_tpu.ops.engine import scan_scores_jit
from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan.sequence import frag_codes_ending
from deciphon_tpu_torch.convert import (costs_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.ops.tables import stack_tables
from deciphon_tpu_torch.workload import window_batch

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

# lengths per (pair, slot): length-1 windows, pad slots (0) and windows
# spanning several 40-position blocks
LENS = np.array([[37, 150, 1, 96, 41, 0, 12, 80],
                 [5, 1, 133, 64, 0, 0, 0, 120]], np.int32)


def make_inputs(Ks, mh, h3c, seed):
    costs = [build_costs(sample_profile(seed + i, k), mh, h3c)
             for i, k in enumerate(Ks)]
    tables, tvecs = stack_tables([costs_from_arrays(**vars(c))
                                  for c in costs])
    rng = np.random.default_rng(seed)
    batch = window_batch(rng, LENS, "cpu", mh, h3c)
    pidx = torch.tensor([i % len(Ks) for i in range(LENS.shape[0])],
                        dtype=torch.int32)
    nlb = -(-int(LENS.max()) // vk.KAPPA)
    return costs, dict(pidx=pidx, tables=tables, tvecs=tvecs, **batch), nlb


def pallas_scores(inp, nlb):
    args = [jnp.asarray(inp[k].numpy()) for k in
            ("pidx", "tables", "tvecs", "xts", "lengths", "starts",
             "codes_all")]
    alt, nul = vp.viterbi_scores_pairs_from_starts(*args, nlb=nlb,
                                                   interpret=True)
    return np.asarray(alt), np.asarray(nul)


def jax_engine_scores(costs, inp):
    """(alt, null) of every real window from the lax.scan engine."""
    codes_all = inp["codes_all"].numpy()
    alt = np.full(LENS.shape, np.inf, np.float32)
    nul = np.full(LENS.shape, np.inf, np.float32)
    for n in range(LENS.shape[0]):
        c = costs[int(inp["pidx"][n])]
        real = [w for w in range(LENS.shape[1]) if LENS[n, w] > 0]
        Lpad = int(LENS.max())
        codes = np.zeros((len(real), Lpad, 5), np.int32)
        for b, w in enumerate(real):
            s, L = int(inp["starts"][n, w]), int(LENS[n, w])
            codes[b, :L] = frag_codes_ending(codes_all[s:s + L, 0])
        xts = inp["xts"][n, real, :13].numpy()
        nu, al = scan_scores_jit(
            jnp.asarray(c.core)[None], jnp.asarray(c.match)[None],
            jnp.asarray(c.null)[None], jnp.asarray(c.background)[None],
            jnp.asarray(xts), jnp.asarray(codes),
            jnp.asarray(LENS[n, real]))
        alt[n, real] = np.asarray(al)[0]
        nul[n, real] = np.asarray(nu)[0]
    return alt, nul


@pytest.mark.parametrize("mh,h3c", [(True, False), (False, True)])
def test_scores_plain_bit_equal_to_pallas(mh, h3c):
    costs, inp, nlb = make_inputs([9, 40], mh, h3c, seed=3)
    alt, nul = vk.scores_pairs(**inp)  # CPU tensors: plain
    assert alt.dtype == torch.float32 and tuple(alt.shape) == LENS.shape
    ra, rn = pallas_scores(inp, nlb)
    assert np.array_equal(alt.numpy(), ra)
    assert np.array_equal(nul.numpy(), rn)
    assert np.isinf(alt.numpy()[LENS == 0]).all()
    assert np.isfinite(alt.numpy()[LENS > 0]).all()
    ja, jn = jax_engine_scores(costs, inp)
    np.testing.assert_allclose(alt.numpy(), ja, rtol=2e-6, atol=2e-5)
    np.testing.assert_allclose(nul.numpy(), jn, rtol=2e-6, atol=2e-5)


def test_scores_plain_bit_equal_to_pallas_wide_plane():
    costs, inp, nlb = make_inputs([150, 60], True, False, seed=11)
    assert inp["tables"].shape[2] == 256
    alt, nul = vk.scores_pairs(**inp)
    ra, rn = pallas_scores(inp, nlb)
    assert np.array_equal(alt.numpy(), ra)
    assert np.array_equal(nul.numpy(), rn)
    ja, jn = jax_engine_scores(costs, inp)
    np.testing.assert_allclose(alt.numpy(), ja, rtol=2e-6, atol=2e-5)
    np.testing.assert_allclose(nul.numpy(), jn, rtol=2e-6, atol=2e-5)


def test_scores_wrapper_checks_inputs():
    _, inp, _ = make_inputs([9], True, False, seed=5)
    bad = dict(inp, starts=inp["starts"].long())
    with pytest.raises(TypeError):
        vk.scores_pairs(**bad)
    bad = dict(inp, xts=inp["xts"][:, :4])
    with pytest.raises(ValueError):
        vk.scores_pairs(**bad)
    bad = dict(inp, codes_all=inp["codes_all"].to("meta"))
    with pytest.raises(ValueError):
        vk.scores_pairs(**bad)
    wide = torch.zeros((1, 1364, 5248), dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        vk.scores_pairs(**dict(inp, tables=wide,
                               tvecs=torch.zeros((1, 8, 5248))))


def test_bucketed_scorer_matches_jax_pair_scorer():
    """Scheduler path: items over two Kp buckets scored through
    BucketedPairScorer's one-transfer wave equal PairScorer.score bit for
    bit and the reference JaxPairScorer within tolerance."""
    from deciphon_tpu.scan import scheduler as ref_sched
    from deciphon_tpu.scan.sequence import Sequence
    from deciphon_tpu.scan.window import Window as RefWindow
    from deciphon_tpu_torch.scan.scheduler import (BucketedPairScorer,
                                                   DeviceSeqCodes, PairItem,
                                                   PairScorer)
    from deciphon_tpu_torch.scan.window import Window
    from deciphon_tpu_torch.workload import random_bases

    ref_costs = [build_costs(sample_profile(s, k))
                 for s, k in [(1, 6), (2, 150), (3, 9)]]
    costs = [costs_from_arrays(**vars(c)) for c in ref_costs]
    rng = np.random.default_rng(5)
    ref_seqs = [Sequence.make(i, f"s{i}", random_bases(rng, 30 + 37 * i))
                for i in range(4)]
    seqs = [sequence_from_arrays(**vars(s)) for s in ref_seqs]
    codes = DeviceSeqCodes(seqs, "cpu")
    items = [PairItem(p_idx=p, s_idx=i, win=Window(0, 0, s.size),
                      multi_hits=True, hmmer3_compat=False, seq=s,
                      gstart=codes.gstart(i, 0))
             for p in range(3) for i, s in enumerate(seqs)]
    ref_items = [ref_sched.PairItem(p_idx=p, s_idx=i,
                                    win=RefWindow(0, 0, s.size),
                                    multi_hits=True, hmmer3_compat=False,
                                    seq=s)
                 for p in range(3) for i, s in enumerate(ref_seqs)]
    # the default scorer packs K = 6 and 9 side by side (seg 64, 2
    # segments) and leaves K = 150 alone in its plain bucket
    bucketed = BucketedPairScorer(costs, "cpu")
    assert [s.Kp for s in bucketed.scorers] == [128, 256]
    bucketed.set_device_codes(codes)
    got = bucketed.collect_all(bucketed.dispatch_all(items))
    assert [it.p_idx for it in items] == [p for p in range(3)
                                          for _ in seqs]
    want = ref_sched.JaxPairScorer(ref_costs).score(ref_items)
    single = PairScorer(costs, "cpu")
    single.set_device_codes(codes)
    alone = single.score(items)
    for it, rit in zip(items, ref_items):
        assert got[id(it)] == alone[id(it)]
        np.testing.assert_allclose(got[id(it)], want[id(rit)],
                                   rtol=2e-6, atol=2e-5)
