"""Port parity of the dense-grid score kernel (B9): its plain version
against the Pallas `_kernel` in interpret mode (gather modes slot and
tregs) and the push form (pending), bit for bit; GridScanEngine against
PallasScanEngine (bit for bit) and the lax.scan engine (the reference's
cross-engine tolerance, tests/test_pallas.py); B9's plain version against
B1's (B4's past Kp 5120) on the same pairs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deciphon_tpu.ops import viterbi_pallas as vp
from deciphon_tpu.ops.costs import build_costs
from deciphon_tpu.ops.engine import ProfilePack, scan_scores_jit
from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan.sequence import frag_codes_ending
from deciphon_tpu.xtrans import xtrans_cost_vector
from deciphon_tpu_torch.convert import costs_from_arrays
from deciphon_tpu_torch.ops import engine as t_engine
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.ops.tables import stack_tables
from deciphon_tpu_torch.workload import window_batch

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)


def make_workload(seeds_ks, B, L, mh=True, h3c=False, seed=0):
    """tests/test_pallas.py's workload: window b has max(1, L - 2b) nt."""
    costs = [build_costs(sample_profile(s, k), mh, h3c) for s, k in seeds_ks]
    rng = np.random.default_rng(seed)
    codes = np.zeros((B, L, 5), np.int32)
    xt = np.zeros((B, 13), np.float32)
    lengths = np.zeros((B,), np.int32)
    for b in range(B):
        n = max(1, L - 2 * b)
        seq = rng.integers(0, 4, size=n).astype(np.int8)
        codes[b, :n] = frag_codes_ending(seq)
        xt[b] = xtrans_cost_vector(mh, h3c, n)
        lengths[b] = n
    return costs, xt, codes, lengths


def port_costs(costs):
    return [costs_from_arrays(**vars(c)) for c in costs]


@pytest.fixture(scope="module")
def grid_case():
    """Two profiles, 9 windows (not a multiple of W = 8): a length-1
    window, a pad (length 0) and windows over two 40-position blocks."""
    costs, xt, codes, lengths = make_workload([(11, 5), (12, 17)], B=9,
                                              L=46, seed=2)
    lengths[3] = 1
    lengths[5] = 0
    eng = vp.PallasScanEngine(costs, interpret=True)
    grid = vk.GridScanEngine(port_costs(costs), device="cpu")
    return costs, xt, codes, lengths, eng, grid


@pytest.mark.parametrize("mode", ["slot", "tregs", "pending"])
def test_grid_plain_bit_equal_to_pallas(grid_case, mode):
    costs, xt, codes, lengths, eng, grid = grid_case
    assert np.array_equal(grid.tables.numpy(), np.asarray(eng.tables))
    assert np.array_equal(grid.tvecs.numpy(), np.asarray(eng.tvecs))
    kap = vp.KAPPA_PENDING if mode == "pending" else vp.KAPPA
    xts, lens, ck = vp.pack_windows(xt, codes, lengths, kappa=kap, mode=mode)
    alt, nul = vp.viterbi_scores_grid(
        eng.tables, eng.tvecs, jnp.asarray(xts), jnp.asarray(lens),
        jnp.asarray(ck), kappa=kap, interpret=True, mode=mode)
    B = len(lengths)
    alt = np.asarray(alt).reshape(2, -1)[:, :B]
    nul = np.asarray(nul).reshape(2, -1)[:, :B]
    before = dict(vk.LAUNCHES)
    got_a, got_n = vk.scores_grid(grid.tables, grid.tvecs,
                                  *grid.grid_inputs(xt, codes, lengths))
    assert vk.LAUNCHES == before  # CPU tensors: the plain version
    assert got_a.shape == got_n.shape == (2, B)
    assert np.array_equal(got_a.numpy(), alt)
    assert np.array_equal(got_n.numpy(), nul)
    assert np.isinf(alt[:, 5]).all() and np.isfinite(alt[:, 3]).all()


@pytest.mark.parametrize("mh,h3c", [(True, False), (False, True)])
def test_grid_engine_matches_pallas_engine(mh, h3c):
    """tests/test_pallas.py's engine workloads: bit for bit against
    PallasScanEngine, within rtol 2e-6 / atol 2e-5 of the lax.scan engine
    (the reference's and the port's)."""
    for seeds_ks, B, L, seed, one in (([(1, 5), (2, 12), (3, 9)], 5, 37, 0,
                                       None),
                                      ([(7, 4)], 3, 70, 9, 2)):
        costs, xt, codes, lengths = make_workload(seeds_ks, B, L, mh, h3c,
                                                  seed)
        if one is not None:
            lengths[one] = 1  # minimal window
        nul_p, alt_p = vp.PallasScanEngine(costs, interpret=True).scores(
            xt, codes, lengths)
        nul_g, alt_g = vk.GridScanEngine(port_costs(costs), "cpu").scores(
            xt, codes, lengths)
        assert np.array_equal(nul_g, nul_p) and np.array_equal(alt_g, alt_p)
        pack = ProfilePack.from_costs(costs, lane_multiple=1)
        nul_j, alt_j = scan_scores_jit(
            *(jnp.asarray(a) for a in (pack.core, pack.match, pack.null,
                                       pack.background, xt, codes,
                                       lengths)))
        np.testing.assert_allclose(alt_g, alt_j, rtol=2e-6, atol=2e-5)
        np.testing.assert_allclose(nul_g, nul_j, rtol=2e-6, atol=2e-5)
        tpack = t_engine.ProfilePack.from_costs(port_costs(costs),
                                                lane_multiple=1)
        nul_t, alt_t = t_engine.scan_scores(
            *(torch.from_numpy(a) for a in (tpack.core, tpack.match,
                                            tpack.null, tpack.background,
                                            xt, codes, lengths)))
        np.testing.assert_allclose(alt_g, alt_t.numpy(), rtol=2e-6,
                                   atol=2e-5)
        np.testing.assert_allclose(nul_g, nul_t.numpy(), rtol=2e-6,
                                   atol=2e-5)


@pytest.mark.parametrize("Kp", [128, 5248])
def test_grid_plain_equals_b1_plain(Kp):
    """Every (profile, window) pair of the grid scored by B1's plain
    version (B4's, the same function, past Kp 5120): pair p holds all the
    windows in its slots."""
    P = 2
    costs = [build_costs(sample_profile(40 + i, k)) for i, k in
             enumerate((Kp - 2, Kp // 3))]
    tables, tvecs = stack_tables(port_costs(costs), Kp)
    lens = np.array([[37, 1, 0, 52, 80 if Kp == 128 else 41]], np.int32)
    batch = window_batch(np.random.default_rng(Kp), lens)
    B = lens.shape[1]
    xts, starts = batch["xts"][0], batch["starts"][0]
    alt, nul = vk.scores_grid(tables, tvecs, xts.contiguous(),
                              batch["lengths"][0, :, 0].contiguous(),
                              starts.contiguous(), batch["codes_all"])
    a1, n1 = vk.scores_pairs_plain(
        torch.arange(P, dtype=torch.int32), tables, tvecs,
        xts.expand(P, B, 16).contiguous(),
        batch["lengths"].expand(P, B, 1).contiguous(),
        starts.expand(P, B).contiguous(), batch["codes_all"])
    assert torch.equal(alt, a1) and torch.equal(nul, n1)
    assert torch.isinf(alt[:, 2]).all() and torch.isfinite(alt[:, 1]).all()


def test_scores_grid_contract():
    costs = port_costs([build_costs(sample_profile(3, 9))])
    grid = vk.GridScanEngine(costs, device="cpu")
    xts, lens, starts, codes_all = grid.grid_inputs(
        np.zeros((2, 13), np.float32), np.zeros((2, 6, 5), np.int32),
        np.array([6, 0], np.int32))
    assert starts.tolist() == [0, 6] and codes_all.shape == (12, 5)
    with pytest.raises(TypeError, match="lengths"):
        vk.scores_grid(grid.tables, grid.tvecs, xts, lens.long(), starts,
                       codes_all)
    with pytest.raises(ValueError, match="no rows"):
        vk.scores_grid(grid.tables, grid.tvecs, xts, lens, starts,
                       codes_all[:0])
    wide = torch.zeros((1, 1364, vk.MAX_LARGE_KP + 128))
    with pytest.raises(NotImplementedError, match="16384"):
        vk.scores_grid(wide, torch.zeros((1, 8, wide.shape[2])), xts, lens,
                       starts, codes_all)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vk.GridScanEngine(costs)
