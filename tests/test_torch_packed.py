"""Port parity of the lane-packed score modes (B6, B7): the packed tables
and the plain PyTorch versions against the Pallas packed kernels in
interpret mode, and against the port's own plain B1 per segment.

Inputs come from numpy seeds; profiles, costs and the read cross into the
port as arrays (deciphon_tpu_torch.convert); both sides get the same
packed tables and the same START-indexed code table.  Pad entries are +inf
in the port (the reference's end-block compaction leaves junk there), so
only real entries are compared with Pallas.  Tolerance: none (min-plus with
the kernels' f32 operation order is exact).
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
from deciphon_tpu_torch.ops import tables as tt
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.scan.scheduler import DeviceSeqCodes
from deciphon_tpu_torch.workload import (packed_chain_inputs, random_bases,
                                         window_scores)
from deciphon_tpu_torch.xtrans import xtrans_cost_vector

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

KAPPA = vk.KAPPA
W = 8


def jx(t):
    return jnp.asarray(t.numpy())


def make_costs(ks, seed=51):
    ref = [build_costs(sample_profile(seed + i, k)) for i, k in enumerate(ks)]
    return ref, [costs_from_arrays(**vars(c)) for c in ref]


def make_codes(n=1600, seed=7):
    rng = np.random.default_rng(seed)
    seq = Sequence.make(0, "s0", random_bases(rng, n))
    return DeviceSeqCodes([sequence_from_arrays(**vars(seq))], "cpu")


@pytest.mark.parametrize("seg,nseg,ks", [
    (64, 2, [20, 50]),
    (64, 4, [20, 40, 62]),  # one missing trailing segment, K + 2 == seg
    (128, 2, [100, 120]),
    (128, 3, [60, 90, 110]),  # Kp 384
    (192, 2, [150, 188]),
])
def test_build_tables_packed_bit_equal(seg, nseg, ks):
    ref, costs = make_costs(ks)
    table, tvec = tt.build_tables_packed(costs, seg, nseg)
    rt, rv = vp.build_tables_packed(ref, seg, nseg)
    Kp = seg * nseg
    assert tt.packed_width(Kp) == vp.packed_width(Kp) == 2 * Kp + tt.PACK_PAD
    assert tuple(table.shape) == (1364, 2 * Kp + 128)
    assert table.dtype == torch.float32 and tvec.dtype == torch.float32
    assert np.array_equal(table.numpy(), rt)
    assert np.array_equal(tvec.numpy(), rv)
    tables, tvecs = tt.stack_tables_packed(costs + costs[:1], seg, nseg)
    npack = -(-(len(ks) + 1) // nseg)
    assert tuple(tables.shape) == (npack, 1364, 2 * Kp + 128)
    assert np.array_equal(tables[0].numpy()[:, :seg * min(nseg, len(ks))],
                          rt[:, :seg * min(nseg, len(ks))])
    assert tuple(tvecs.shape) == (npack, 8, Kp)


def test_build_tables_packed_keeps_the_pad_lane():
    _, costs = make_costs([20, 64])
    with pytest.raises(ValueError, match="pad lane"):
        tt.build_tables_packed(costs, 64, 2)  # K + 1 > seg
    with pytest.raises(ValueError, match="segments"):
        tt.build_tables_packed(costs + costs, 64, 2)


def packed_inputs(codes, costs, seg, nseg, wins):
    """B6 wrapper arguments: pack 0 holds `costs`; pair 0 carries `wins`
    ((start, stop) of read 0) one per slot, pair 1 is all pad."""
    tables, tvecs = tt.stack_tables_packed(costs, seg, nseg)
    N = 2
    xts = np.zeros((N, W, 16), np.float32)
    lens = np.zeros((N, W, 1), np.int32)
    starts = np.full((N, W), codes.pad_start, np.int32)
    for wi, (a, b) in enumerate(wins):
        xts[0, wi, :13] = xtrans_cost_vector(True, False, b - a)
        lens[0, wi, 0] = b - a
        starts[0, wi] = codes.gstart(0, a)
    return dict(pidx=torch.zeros((N,), dtype=torch.int32), tables=tables,
                tvecs=tvecs, xts=torch.from_numpy(xts),
                lengths=torch.from_numpy(lens),
                starts=torch.from_numpy(starts), codes_all=codes.dev)


def pallas_packed(inp, nseg):
    nlb = -(-int(inp["lengths"].max()) // KAPPA)
    alt, nul = vp.viterbi_scores_pairs_packed(
        jx(inp["pidx"]), jx(inp["tables"]), jx(inp["tvecs"]), jx(inp["xts"]),
        jx(inp["lengths"]), starts=jx(inp["starts"]),
        codes_all=jx(inp["codes_all"]), nlb=nlb, kappa=KAPPA, nseg=nseg,
        interpret=True)
    return np.asarray(alt), np.asarray(nul)


WINS = [(0, 37), (100, 260), (300, 380), (0, 400), (500, 700), (700, 755),
        (40, 440)]


@pytest.mark.parametrize("seg,nseg,ks", [
    (64, 2, [24, 41]),
    (128, 4, [60, 120, 97]),  # Kp 512, the last segment missing
])
def test_packed_plain_bit_equal_to_pallas_and_b1(seg, nseg, ks):
    codes = make_codes()
    _, costs = make_costs(ks)
    inp = packed_inputs(codes, costs, seg, nseg, WINS)
    alt, nul = vk.scores_pairs_packed(**inp, nseg=nseg)  # CPU: plain
    assert tuple(alt.shape) == (2, W, nseg) and alt.dtype == torch.float32
    ra, rn = pallas_packed(inp, nseg)
    real = inp["lengths"].numpy()[..., 0] > 0
    assert np.array_equal(alt.numpy()[real], ra[real])
    assert np.array_equal(nul.numpy()[real], rn[real])
    assert np.isinf(alt.numpy()[~real]).all()
    assert np.isinf(nul.numpy()[~real]).all()
    # each segment equals its profile scored alone by the port's plain B1
    t1, v1 = tt.stack_tables(costs)
    for s in range(len(ks)):
        ba, bn = window_scores(
            t1, v1, codes.dev, s,
            [(codes.gstart(0, a), codes.gstart(0, b)) for a, b in WINS])
        assert np.array_equal(alt[0, :len(WINS), s].numpy(), ba.numpy())
        assert np.array_equal(nul[0, :len(WINS), s].numpy(), bn.numpy())
        assert np.isfinite(ba.numpy()).all()
    # a missing trailing segment scores +inf
    for s in range(len(ks), nseg):
        assert np.isinf(alt[:, :, s].numpy()).all()
        assert np.isinf(nul[:, :, s].numpy()).all()


def test_packed_plain_equals_b1_at_seg_192():
    """Kp 384 (seg 192, two segments): no Pallas compile, the port's own
    plain B1 is the reference."""
    codes = make_codes()
    _, costs = make_costs([150, 188])
    inp = packed_inputs(codes, costs, 192, 2, WINS[:4])
    alt, nul = vk.scores_pairs_packed(**inp, nseg=2)
    t1, v1 = tt.stack_tables(costs)
    for s in range(2):
        ba, bn = window_scores(
            t1, v1, codes.dev, s,
            [(codes.gstart(0, a), codes.gstart(0, b)) for a, b in WINS[:4]])
        assert np.array_equal(alt[0, :4, s].numpy(), ba.numpy())
        assert np.array_equal(nul[0, :4, s].numpy(), bn.numpy())


def pallas_packed_chained(tables, tvecs, meta, nseg, nlb):
    alt, nul = vp.viterbi_scores_pairs_packed_chained(
        jx(meta["pidx"]), jx(tables), jx(tvecs),
        *(jx(meta[k]) for k in ("run_sblk", "run_len", "run_gstart",
                                "win_sblk", "win_len", "win_xti", "xt_lut",
                                "codes_all")),
        nlb=nlb, nseg=nseg, kappa=KAPPA, interpret=True)
    return np.asarray(alt), np.asarray(nul)


def test_packed_chained_plain_bit_equal_to_pallas_shared_lists():
    """B7 with the scheduler's layout: every segment lists the slot's code
    runs as its windows (tests/test_chain_packed.py's chains)."""
    SEG, NSEG = 64, 2
    codes = make_codes()
    _, costs = make_costs([24, 41])
    tables, tvecs = tt.stack_tables_packed(costs, SEG, NSEG)
    wins = WINS + [(900, 1100)]
    chains = [[wins[0], wins[2], wins[4]], [wins[1], wins[3]],
              [wins[5], wins[6], wins[7]]]
    meta = packed_chain_inputs(codes, [(0, chains)], n_pairs=2, cmax=4,
                               nseg=NSEG)
    alt, nul = vk.scores_pairs_packed_chained(tables=tables, tvecs=tvecs,
                                              **meta, nseg=NSEG)
    assert tuple(alt.shape) == (2, W, NSEG, 4)
    blocks = -(-meta["run_len"].numpy() // KAPPA)
    ra, rn = pallas_packed_chained(tables, tvecs, meta, NSEG,
                                   int(blocks.sum(axis=2).max()))
    real = meta["win_len"].numpy() > 0
    assert real.sum() == len(wins) * NSEG
    assert np.array_equal(alt.numpy()[real], ra[real])
    assert np.array_equal(nul.numpy()[real], rn[real])
    assert np.isinf(alt.numpy()[~real]).all()
    assert np.isinf(nul.numpy()[~real]).all()
    # every entry equals its window on the unchained packed path
    flat = [w for chain in chains for w in chain]
    inp = packed_inputs(codes, costs, SEG, NSEG, flat)
    pa, pn = vk.scores_pairs_packed(**inp, nseg=NSEG)
    i = 0
    for s, chain in enumerate(chains):
        for c in range(len(chain)):
            assert torch.equal(alt[0, s, :, c], pa[0, i])
            assert torch.equal(nul[0, s, :, c], pn[0, i])
            i += 1


def test_packed_chained_plain_bit_equal_to_pallas_per_segment_lists():
    """B7 with window lists that differ per segment over one shared run
    (tests/test_chain_packed.py's second case): each segment's scores
    equal Pallas and its own windows on the unchained packed path."""
    SEG, NSEG = 64, 2
    codes = make_codes()
    _, costs = make_costs([24, 41])
    tables, tvecs = tt.stack_tables_packed(costs, SEG, NSEG)
    seg_wins = [[(0, 400), (400, 800), (800, 1195)],
                [(0, 800), (800, 1100)]]
    N, C = 1, 3
    run_sblk = np.zeros((N, W, 1), np.int32)
    run_len = np.zeros((N, W, 1), np.int32)
    run_gst = np.full((N, W, 1), codes.pad_start, np.int32)
    run_len[0, 0, 0] = 1200
    run_gst[0, 0, 0] = codes.gstart(0, 0)
    wsb = np.zeros((N, W, NSEG, C), np.int32)
    wln = np.zeros((N, W, NSEG, C), np.int32)
    wxt = np.zeros((N, W, NSEG, C), np.int32)
    lut = np.zeros((16, 16), np.float32)
    rows: dict[int, int] = {}
    for s, ws in enumerate(seg_wins):
        for c, (a, b) in enumerate(ws):
            r = rows.setdefault(b - a, len(rows))
            lut[r, :13] = xtrans_cost_vector(True, False, b - a)
            wsb[0, 0, s, c] = a // KAPPA
            wln[0, 0, s, c] = b - a
            wxt[0, 0, s, c] = r
    meta = {k: torch.from_numpy(v) for k, v in dict(
        pidx=np.zeros((N,), np.int32), run_sblk=run_sblk, run_len=run_len,
        run_gstart=run_gst, win_sblk=wsb, win_len=wln, win_xti=wxt,
        xt_lut=lut).items()}
    meta["codes_all"] = codes.dev
    alt, nul = vk.scores_pairs_packed_chained(tables=tables, tvecs=tvecs,
                                              **meta, nseg=NSEG)
    ra, rn = pallas_packed_chained(tables, tvecs, meta, NSEG, 30)
    real = wln > 0
    assert np.array_equal(alt.numpy()[real], ra[real])
    assert np.array_equal(nul.numpy()[real], rn[real])
    assert np.isinf(alt.numpy()[~real]).all()
    for s, ws in enumerate(seg_wins):
        inp = packed_inputs(codes, costs, SEG, NSEG, ws)
        pa, pn = vk.scores_pairs_packed(**inp, nseg=NSEG)
        for c in range(len(ws)):
            assert alt[0, 0, s, c] == pa[0, c, s]
            assert nul[0, 0, s, c] == pn[0, c, s]


def test_packed_wrappers_check_inputs():
    codes = make_codes(400)
    _, costs = make_costs([24, 41])
    inp = packed_inputs(codes, costs, 64, 2, WINS[:2])
    with pytest.raises(TypeError):
        vk.scores_pairs_packed(**dict(inp, starts=inp["starts"].long()),
                               nseg=2)
    with pytest.raises(ValueError):  # an unpacked table row width
        vk.scores_pairs_packed(**dict(inp, tables=inp["tables"][:, :, :128]),
                               nseg=2)
    with pytest.raises(NotImplementedError):  # 128 lanes in 3 segments
        vk.scores_pairs_packed(**inp, nseg=3)
    with pytest.raises(ValueError):  # mixed devices never fall back
        vk.scores_pairs_packed(**dict(inp, xts=inp["xts"].to("meta")),
                               nseg=2)
    wide = torch.zeros((1, 1364, tt.packed_width(2176)))
    with pytest.raises(NotImplementedError):  # past PACK_MAX_KP lanes
        vk.scores_pairs_packed(**dict(inp, tables=wide,
                                      tvecs=torch.zeros((1, 8, 2176))),
                               nseg=2)
    meta = packed_chain_inputs(codes, [(0, [[(0, 100)]])], n_pairs=1,
                               cmax=2, nseg=2)
    tables, tvecs = inp["tables"], inp["tvecs"]
    with pytest.raises(ValueError):  # win_* are (N, W, nseg, C)
        vk.scores_pairs_packed_chained(
            tables=tables, tvecs=tvecs,
            **dict(meta, win_len=meta["win_len"][:, :, 0]), nseg=2)
    with pytest.raises(TypeError):
        vk.scores_pairs_packed_chained(
            tables=tables, tvecs=tvecs,
            **dict(meta, run_len=meta["run_len"].long()), nseg=2)
    before = dict(vk.LAUNCHES)
    vk.scores_pairs_packed_chained(tables=tables, tvecs=tvecs, **meta,
                                   nseg=2)
    assert vk.LAUNCHES == before  # CPU tensors: no kernel launch
