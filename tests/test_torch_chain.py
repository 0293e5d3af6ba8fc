"""Port parity of the chain, gang and carry score modes (B3, B5, B8): the
plain PyTorch versions against the Pallas kernels in interpret mode, bit
for bit on every real entry, and against B1 on the same windows.

Inputs come from numpy seeds; both sides get the same tables (the port's
`stack_tables`) and the same START-indexed code table.  Pad entries are
+inf in the port (the reference's compaction leaves junk there), so only
real entries are compared with Pallas.  Tolerance: none (min-plus with the
kernels' f32 operation order is exact).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deciphon_tpu.ops import viterbi_pallas as vp
from deciphon_tpu.ops.costs import build_costs
from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan.sequence import Sequence
from deciphon_tpu_torch.convert import (costs_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.ops.tables import stack_tables
from deciphon_tpu_torch.scan.scheduler import DeviceSeqCodes
from deciphon_tpu_torch.workload import (carry_case, chain_inputs,
                                         random_bases, run_carry_calls,
                                         window_scores)
from deciphon_tpu_torch.xtrans import xtrans_cost_vector

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

KAPPA = vk.KAPPA
W = 8
# (start, stop) windows of one 2400-nt read, as tests/test_chain.py lays
# them out: slot 0 <- wins[0, 2, 4], slot 1 <- wins[1, 3], slot 2 <-
# wins[5, 6, 7]; pairs 0-2 carry these chains, pair 3 is all pad
WINS = [(0, 37), (100, 260), (300, 380), (0, 400), (500, 700), (700, 755),
        (40, 440), (900, 1100)]
CHAINS = [[WINS[0], WINS[2], WINS[4]], [WINS[1], WINS[3]],
          [WINS[5], WINS[6], WINS[7]]]


def setup(mh=True, h3c=False, Ks=(24, 41)):
    rng = np.random.default_rng(5)
    seq = sequence_from_arrays(
        **vars(Sequence.make(0, "s0", random_bases(rng, 2400))))
    codes = DeviceSeqCodes([seq], "cpu")
    costs = [costs_from_arrays(
        **vars(build_costs(sample_profile(31 + i, k), mh, h3c)))
        for i, k in enumerate(Ks)]
    tables, tvecs = stack_tables(costs)
    return codes, tables, tvecs


def jx(t):
    return jnp.asarray(t.numpy())


def b1_scores(codes, tables, tvecs, p, wins, mh=True, h3c=False):
    """(alt, null) of each (start, stop) window of read 0 scored alone by
    B1."""
    alt, nul = window_scores(
        tables, tvecs, codes.dev, p,
        [(codes.gstart(0, a), codes.gstart(0, b)) for a, b in wins], mh, h3c)
    return alt.numpy(), nul.numpy()


@pytest.mark.parametrize("mh,h3c", [(True, False), (False, True)])
def test_chained_plain_bit_equal_to_pallas(mh, h3c):
    codes, tables, tvecs = setup(mh, h3c)
    meta = chain_inputs(codes, [(0, CHAINS), (1, CHAINS), (0, CHAINS)],
                        n_pairs=4, cmax=4, multi_hits=mh, hmmer3_compat=h3c)
    alt, nul = vk.scores_pairs_chained(tables=tables, tvecs=tvecs, **meta)
    assert tuple(alt.shape) == (4, W, 4) and alt.dtype == torch.float32
    blocks = -(-meta["win_len"].numpy() // KAPPA)
    nlb = int(blocks.sum(axis=2).max())
    ra, rn = vp.viterbi_scores_pairs_chained(
        jx(meta["pidx"]), jx(tables), jx(tvecs), jx(meta["win_sblk"]),
        jx(meta["win_len"]), jx(meta["win_gstart"]), jx(meta["win_xti"]),
        jx(meta["xt_lut"]), jx(codes.dev), nlb=nlb, kappa=KAPPA,
        interpret=True)
    real = meta["win_len"].numpy() > 0
    assert real.sum() == 3 * len(WINS)
    assert np.array_equal(alt.numpy()[real], np.asarray(ra)[real])
    assert np.array_equal(nul.numpy()[real], np.asarray(rn)[real])
    assert np.isinf(alt.numpy()[~real]).all()
    assert np.isinf(nul.numpy()[~real]).all()
    assert np.isfinite(alt.numpy()[real]).all()
    # every entry equals its window scored alone by B1
    for pi, p in enumerate((0, 1, 0)):
        for s, chain in enumerate(CHAINS):
            ba, bn = b1_scores(codes, tables, tvecs, p, chain, mh, h3c)
            assert np.array_equal(alt[pi, s, :len(chain)].numpy(), ba)
            assert np.array_equal(nul[pi, s, :len(chain)].numpy(), bn)


def mixed_setup():
    """B5 inputs: three profiles interleaved over the slots of 2 pairs,
    one pad slot each.  Returns (codes, the wrapper's arguments)."""
    codes, tables, tvecs = setup(Ks=(24, 41, 9))
    wins = [(0, 37), (100, 260), (300, 380), (0, 130), (500, 700),
            (700, 755), (40, 240)]
    N = 2
    pidx = np.zeros((N, W), np.int32)
    lens = np.zeros((N, W, 1), np.int32)
    starts = np.full((N, W), codes.pad_start, np.int32)
    xts = np.zeros((N, W, 16), np.float32)
    for i, (a, b) in enumerate(wins + wins[:5]):
        n, w = divmod(i, W)
        pidx[n, w] = (i + n) % 3
        lens[n, w, 0] = b - a
        starts[n, w] = codes.gstart(0, a)
        xts[n, w, :13] = xtrans_cost_vector(True, False, b - a)
    return codes, dict(pidx=torch.from_numpy(pidx), tables=tables,
                       tvecs=tvecs, xts=torch.from_numpy(xts),
                       lengths=torch.from_numpy(lens),
                       starts=torch.from_numpy(starts), codes_all=codes.dev)


def mixed_vs_pallas(args, ref_jit):
    """B5's wrapper against a Pallas mixed-profile kernel on real slots;
    returns the port's (alt, null) and the real-slot mask."""
    alt, nul = vk.scores_pairs_mixed(**args)
    lens = args["lengths"].numpy()
    ra, rn = ref_jit(
        *(jx(args[k]) for k in ("pidx", "tables", "tvecs", "xts", "lengths",
                                "starts", "codes_all")),
        kappa=KAPPA, nlb=-(-int(lens.max()) // KAPPA), interpret=True)
    real = lens[..., 0] > 0
    assert np.array_equal(alt.numpy()[real], np.asarray(ra)[real])
    assert np.array_equal(nul.numpy()[real], np.asarray(rn)[real])
    assert np.isinf(alt.numpy()[~real]).all()
    return alt, nul, real


def test_mixed_plain_bit_equal_to_pallas():
    """B5: three profiles interleaved over the slots of each pair, against
    the VMEM-table mixed kernel (`_scores_pairs_mixed_vmem_core`)."""
    codes, args = mixed_setup()
    alt, nul, real = mixed_vs_pallas(args,
                                     vp._gather_scores_pairs_mixed_vmem_jit)
    pidx, lens, starts = (args[k].numpy() for k in
                          ("pidx", "lengths", "starts"))
    # and each slot equals B1 on its own profile
    for n in range(pidx.shape[0]):
        for w in np.nonzero(real[n])[0]:
            a = int(starts[n, w]) - codes.gstart(0, 0)
            ba, bn = b1_scores(codes, args["tables"], args["tvecs"],
                               int(pidx[n, w]),
                               [(a, a + int(lens[n, w, 0]))])
            assert alt[n, w] == ba[0] and nul[n, w] == bn[0]


def test_mixed_plain_bit_equal_to_pallas_hbm():
    """B5 against B4's mixed form (`_scores_pairs_hbm_core` mixed=True),
    the kernel the reference's gang runs once the bucket's table stack
    exceeds its VMEM budget, as on the long-read scan."""
    _, args = mixed_setup()
    mixed_vs_pallas(args, vp._gather_scores_pairs_hbm_mixed_jit)


def test_carry_plain_bit_equal_to_pallas():
    """B8: a 13-block window split over 4 consecutive 4-block calls with a
    normal window riding in slot 1 of each call (`workload.carry_case`).
    Scores of real entries and the exported carry planes of the
    continuing slot equal the Pallas kernel's at every call, and the last
    segment equals the window scored whole by B1."""
    case = carry_case(128, seed=5)
    got = run_carry_calls(vk.scores_pairs_chained_carry, case)
    assert len(got) == 4
    tables, tvecs = jx(case["tables"]), jx(case["tvecs"])
    ref = None
    for t, (call, port) in enumerate(zip(case["calls"], got)):
        if ref is None:
            rb = jnp.zeros((1, 13, vk.CW, 128), jnp.float32)
            rs = jnp.zeros((1, 32, vk.CW, 1), jnp.float32)
        else:
            rb, rs = vp._carry_permute_jit(1, 1)(ref[2], ref[3],
                                                 jx(call["route"]))
        ref = vp.viterbi_scores_pairs_chained_carry(
            jx(call["pidx"]), tables, tvecs,
            *(jx(call[k]) for k in ("win_sblk", "win_len", "win_gstart",
                                    "win_xti", "conts")),
            rb, rs, jx(case["xt_lut"]), jx(case["codes_all"]), nlb=4,
            kappa=KAPPA, interpret=True)
        # the ride-along window (slot 1) and, in the last call, the long
        # window's final segment (slot 0)
        last = t == len(got) - 1
        for w in [1, 0] if last else [1]:
            assert port[0][0, w, 0] == np.asarray(ref[0])[0, w, 0], (t, w)
            assert port[1][0, w, 0] == np.asarray(ref[1])[0, w, 0], (t, w)
        if not last:  # the continuing slot's exported state
            assert np.array_equal(port[2][:, :, 0].numpy(),
                                  np.asarray(ref[2])[:, :, 0])
            assert np.array_equal(port[3][:, :, 0].numpy(),
                                  np.asarray(ref[3])[:, :, 0])
            assert torch.isfinite(port[2][0, 10, 0]).any()
    wa, wn = window_scores(case["tables"], case["tvecs"], case["codes_all"],
                           0, [case["whole"]] + case["rides"])
    for t, port in enumerate(got):
        assert port[0][0, 1, 0] == wa[1 + t] and port[1][0, 1, 0] == wn[1 + t]
    assert got[-1][0][0, 0, 0] == wa[0] and got[-1][1][0, 0, 0] == wn[0]


def test_carry_permute_matches_reference():
    rng = np.random.default_rng(3)
    Ns, Nd, Kp = 2, 3, 128
    big = rng.standard_normal((Ns, 13, vk.CW, Kp)).astype(np.float32)
    sml = rng.standard_normal((Ns, 32, vk.CW, 1)).astype(np.float32)
    route = rng.integers(0, Ns * vk.CW, size=Nd * vk.CW).astype(np.int32)
    gb, gs = vk.carry_permute(torch.from_numpy(big), torch.from_numpy(sml),
                              torch.from_numpy(route))
    wb, ws = vp._carry_permute_jit(Ns, Nd)(jnp.asarray(big),
                                           jnp.asarray(sml),
                                           jnp.asarray(route))
    assert gb.is_contiguous() and tuple(gb.shape) == (Nd, 13, vk.CW, Kp)
    assert np.array_equal(gb.numpy(), np.asarray(wb))
    assert np.array_equal(gs.numpy(), np.asarray(ws))


def test_chain_wrappers_check_inputs():
    codes, tables, tvecs = setup()
    meta = chain_inputs(codes, [(0, CHAINS)], n_pairs=1, cmax=4)
    with pytest.raises(TypeError):
        vk.scores_pairs_chained(tables=tables, tvecs=tvecs,
                                **dict(meta, win_len=meta["win_len"].long()))
    with pytest.raises(ValueError):
        vk.scores_pairs_chained(tables=tables, tvecs=tvecs,
                                **dict(meta, win_xti=meta["win_xti"][:, :4]))
    with pytest.raises(ValueError):  # mixed devices never fall back
        vk.scores_pairs_chained(tables=tables.to("meta"), tvecs=tvecs,
                                **meta)
    Kp = tables.shape[2]
    cw = dict(conts=torch.zeros((1, W), dtype=torch.int32),
              cbig_in=torch.zeros((1, 13, vk.CW, Kp)),
              csml_in=torch.zeros((1, 32, 4, 1)))
    with pytest.raises(ValueError):
        vk.scores_pairs_chained_carry(tables=tables, tvecs=tvecs, **meta,
                                      **cw)
    with pytest.raises(ValueError):  # B5 takes one profile per slot
        vk.scores_pairs_mixed(
            torch.zeros((1,), dtype=torch.int32), tables, tvecs,
            torch.zeros((1, W, 16)), torch.zeros((1, W, 1), dtype=torch.int32),
            torch.zeros((1, W), dtype=torch.int32), codes.dev)
