"""Port parity: the B2 path kernel's plain version against the Pallas path
kernel (interpret mode) and the viterbi_jax oracle, bit for bit."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deciphon_tpu.ops import viterbi_pallas as vp
from deciphon_tpu.ops.costs import build_costs
from deciphon_tpu.ops.viterbi_jax import viterbi_path_batch
from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan.sequence import frag_codes_ending
from deciphon_tpu_torch.convert import costs_from_arrays
from deciphon_tpu_torch.ops.costs import CT_DD, CT_DDCUM, dd_cum_row
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.ops.tables import stack_tables
from deciphon_tpu_torch.workload import window_batch

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

LENS = np.array([[33, 47, 1, 130, 0, 21, 0, 0],
                 [96, 5, 64, 0, 0, 0, 0, 0]], np.int32)


def make_inputs(Ks, mh, h3c, seed):
    costs = [build_costs(sample_profile(seed + i, k), mh, h3c)
             for i, k in enumerate(Ks)]
    tables, tvecs = stack_tables([costs_from_arrays(**vars(c))
                                  for c in costs])
    batch = window_batch(np.random.default_rng(seed), LENS, "cpu", mh, h3c)
    pidx = torch.tensor([i % len(Ks) for i in range(LENS.shape[0])],
                        dtype=torch.int32)
    nlb = -(-int(LENS.max()) // vk.PATH_KAPPA)
    return costs, dict(pidx=pidx, tables=tables, tvecs=tvecs, **batch), nlb


def real_slots():
    return [(n, w) for n in range(LENS.shape[0])
            for w in range(LENS.shape[1]) if LENS[n, w] > 0]


@pytest.mark.parametrize("Ks,mh,h3c", [([9, 40], True, False),
                                       ([9, 40], False, True),
                                       ([150, 70], True, False)])
def test_paths_plain_bit_equal_to_pallas(Ks, mh, h3c):
    _, inp, nlb = make_inputs(Ks, mh, h3c, seed=len(Ks) + Ks[0])
    xn, nd = vk.paths_pairs(**inp, nlb=nlb)  # CPU tensors: plain
    Kp = inp["tables"].shape[2]
    Lk = nlb * vk.PATH_KAPPA
    assert xn.dtype == torch.int32 and tuple(xn.shape) == (2, 8, Lk)
    assert tuple(nd.shape) == (2, 8, Lk, Kp)
    args = [jnp.asarray(inp[k].numpy()) for k in
            ("pidx", "tables", "tvecs", "xts", "lengths")]
    rx, rd = vp.viterbi_paths_pairs(
        *args, starts=jnp.asarray(inp["starts"].numpy()),
        codes_all=jnp.asarray(inp["codes_all"].numpy()), nlb=nlb,
        kappa=vk.PATH_KAPPA, interpret=True)
    rx, rd = np.asarray(rx), np.asarray(rd)
    for n, w in real_slots():
        L = LENS[n, w]
        assert np.array_equal(xn[n, w, :L].numpy(), rx[n, w, :L]), (n, w)
        assert np.array_equal(nd[n, w, :L].numpy(), rd[n, w, :L]), (n, w)


@pytest.mark.parametrize("Ks", [[9, 40], [150, 70]])
def test_paths_plain_bit_equal_to_viterbi_jax(Ks):
    costs, inp, nlb = make_inputs(Ks, True, False, seed=7 + Ks[0])
    xn, nd = vk.paths_pairs(**inp, nlb=nlb)
    codes_all = inp["codes_all"].numpy()
    Lmax = int(LENS.max())
    for n in range(LENS.shape[0]):
        c = costs[int(inp["pidx"][n])]
        slots = [w for w in range(LENS.shape[1]) if LENS[n, w] > 0]
        codes = np.zeros((len(slots), Lmax, 5), np.int32)
        for b, w in enumerate(slots):
            L, s = int(LENS[n, w]), int(inp["starts"][n, w])
            codes[b, :L] = frag_codes_ending(codes_all[s:s + L, 0])
        _, oxn, ond = viterbi_path_batch(
            jnp.asarray(c.core), jnp.asarray(c.match), jnp.asarray(c.null),
            jnp.asarray(c.background),
            jnp.asarray(inp["xts"][n, slots, :13].numpy()),
            jnp.asarray(codes), jnp.asarray(LENS[n, slots]))
        oxn, ond = np.asarray(oxn), np.asarray(ond)
        for b, w in enumerate(slots):
            L = int(LENS[n, w])
            kx = xn[n, w, :L].numpy().astype(np.uint32)
            kn = nd[n, w, :L, :c.K].numpy().astype(np.uint16)
            assert (kx == oxn[b, 1:L + 1]).all(), (n, w)
            assert (kn == ond[b, 1:L + 1, :c.K]).all(), (n, w)


def tied(costs):
    """The same profile with every emission and transition cost equal:
    paths of one length tie, so the first-minimum order of the candidates
    decides nearly every trellis word."""
    core = costs.core.copy()
    core[:8] = np.where(np.isfinite(core[:8]), np.float32(0.5), core[:8])
    core[CT_DDCUM] = dd_cum_row(core[CT_DD])
    return dataclasses.replace(
        costs, core=core, match=np.full_like(costs.match, 2.0),
        null=np.full_like(costs.null, 1.5),
        background=np.full_like(costs.background, 1.5))


def test_paths_plain_bit_equal_to_pallas_on_ties():
    """A tie-heavy profile pins the candidate order (t 5..1, then BM, MM,
    IM, DM and II, MI, first minimum kept) that the path kernel keeps."""
    costs = [tied(costs_from_arrays(**vars(build_costs(sample_profile(
        31 + i, k))))) for i, k in enumerate((9, 40))]
    tables, tvecs = stack_tables(costs)
    batch = window_batch(np.random.default_rng(31), LENS, "cpu")
    inp = dict(pidx=torch.tensor([0, 1], dtype=torch.int32), tables=tables,
               tvecs=tvecs, **batch)
    nlb = -(-int(LENS.max()) // vk.PATH_KAPPA)
    xn, nd = vk.paths_pairs(**inp, nlb=nlb)
    args = [jnp.asarray(inp[k].numpy()) for k in
            ("pidx", "tables", "tvecs", "xts", "lengths")]
    rx, rd = vp.viterbi_paths_pairs(
        *args, starts=jnp.asarray(inp["starts"].numpy()),
        codes_all=jnp.asarray(inp["codes_all"].numpy()), nlb=nlb,
        kappa=vk.PATH_KAPPA, interpret=True)
    rx, rd = np.asarray(rx), np.asarray(rd)
    for n, w in real_slots():
        L = LENS[n, w]
        assert np.array_equal(xn[n, w, :L].numpy(), rx[n, w, :L]), (n, w)
        assert np.array_equal(nd[n, w, :L].numpy(), rd[n, w, :L]), (n, w)
