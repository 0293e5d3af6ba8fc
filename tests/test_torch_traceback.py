"""Port parity: the batched traceback walk against the host `unzip` oracle
and the JAX device walk, plus the re-walk of walks that overflow."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deciphon_tpu.ops import traceback as ref_tb
from deciphon_tpu.ops.costs import build_costs
from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan.sequence import Sequence
from deciphon_tpu_torch.convert import (costs_from_arrays,
                                        frame_profile_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.ops import traceback as tb
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.ops.tables import stack_tables
from deciphon_tpu_torch.scan.scheduler import DeviceSeqCodes
from deciphon_tpu_torch.workload import (assemble_walk_cases,
                                         planted_read, random_bases,
                                         walk_cases)
from deciphon_tpu_torch.xtrans import xtrans_cost_vector

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)


def trellis(K, seed):
    """Plain B2 trellis of 6 windows (2 planted) of one profile, flattened
    to (rows, Lk[, Kp]) as the scheduler hands it to the walk."""
    ref_profile = sample_profile(seed, K)
    profile = frame_profile_from_arrays(**vars(ref_profile))
    tables, tvecs = stack_tables(
        [costs_from_arrays(**vars(build_costs(ref_profile)))])
    rng = np.random.default_rng(seed)
    reads = [planted_read(rng, profile, 3 * K + 40),
             planted_read(rng, profile, 3 * K + 90, noise=0.05),
             random_bases(rng, 61), random_bases(rng, 1),
             random_bases(rng, 140), random_bases(rng, 7)]
    seqs = [sequence_from_arrays(**vars(Sequence.make(i, f"r{i}", r)))
            for i, r in enumerate(reads)]
    codes = DeviceSeqCodes(seqs, "cpu")
    lens = np.zeros((1, 8), np.int32)
    lens[0, :6] = [s.size for s in seqs]
    starts = np.full((1, 8), codes.pad_start, np.int32)
    starts[0, :6] = codes.offsets
    xts = np.zeros((1, 8, 16), np.float32)
    for i, s in enumerate(seqs):
        xts[0, i, :13] = xtrans_cost_vector(True, False, s.size)
    nlb = -(-int(lens.max()) // vk.PATH_KAPPA)
    xn, nd = vk.paths_pairs(
        torch.zeros(1, dtype=torch.int32), tables, tvecs,
        torch.from_numpy(xts), torch.from_numpy(lens[..., None].copy()),
        torch.from_numpy(starts), codes.dev, nlb=nlb)
    Lk = xn.shape[2]
    Kp = nd.shape[3]
    return xn.reshape(8, Lk), nd.reshape(8, Lk, Kp), lens[0, :6].tolist()


@pytest.mark.parametrize("K,seed", [(40, 140), (150, 250)])
def test_walk_plain_matches_unzip_and_jax_walk(K, seed):
    xn, nd, lens = trellis(K, seed)
    Lk, Kp = xn.shape[1], nd.shape[2]
    rows = torch.tensor([3, 0, 5, 1, 4, 2], dtype=torch.int32)
    lt = torch.tensor([lens[r] for r in rows.tolist()], dtype=torch.int32)
    max_steps = Lk + 4 * Kp + 64
    sts, szs, ns, oks = tb.walk(xn, nd, rows, lt, max_steps)  # plain
    assert sts.dtype == torch.int16 and szs.dtype == torch.int8
    assert tuple(sts.shape) == (6, max_steps)
    assert oks.all()

    # the JAX device walk on the reference's padded selection
    sel = xn[rows.long()].numpy()
    xsel = np.pad(sel, ((0, 0), (1, 0)))
    nsel = np.pad(nd[rows.long()].numpy(), ((0, 0), (1, 0), (0, 0)))
    rs, rz, rn, rok = ref_tb._unzip_batch_jit(
        jnp.asarray(xsel), jnp.asarray(nsel), jnp.asarray(lt.numpy()),
        max_steps=max_steps)
    assert np.array_equal(ns.numpy(), np.asarray(rn))
    assert np.array_equal(oks.numpy().astype(bool), np.asarray(rok))
    for b in range(6):
        n = int(ns[b])
        assert np.array_equal(sts[b, :n].numpy().view(np.uint16),
                              np.asarray(rs)[b, :n])
        assert np.array_equal(szs[b, :n].numpy(), np.asarray(rz)[b, :n])

    # assembled paths equal the host oracle walk
    items = [object() for _ in range(6)]
    out = {}
    tb.assemble_path_entries(
        [(items, sts, szs, ns, oks, xn, nd, rows.tolist(), lt.tolist())],
        [a.numpy() for a in (sts, szs, ns, oks)], out)
    for b, r in enumerate(rows.tolist()):
        x, n = tb.host_trellis(xn[r].numpy(), nd[r].numpy(), lens[r])
        want = tb.unzip(x, n, lens[r], Kp)
        assert want == ref_tb.unzip(x, n, lens[r], Kp)
        sid, sz = out[id(items[b])]
        assert list(zip(sid.tolist(), sz.tolist())) == want
    # the planted windows pass through match states
    assert any((out[id(items[1])][0] >> 14) == 0)


@pytest.mark.parametrize("Kp,Lk", [(256, 1024), (37, 301)])
def test_walk_cases_plain_matches_unzip_and_jax_walk(Kp, Lk):
    """The planted edge cases (E to k = 0 and Kp - 1, a D chain along a
    row, an I run down a column, special-state stretches, a domain from
    stage 1, a diagonal domain, an overflow at max_steps, an underflow and
    a length-0 walk): the walk equals the reference's device walk step for
    step, every walk that ends equals its planted path and the host
    `unzip` (the overflow after its re-walk), and the underflow raises in
    both `unzip` and `rewalk`."""
    c = walk_cases(Kp, Lk, seed=Kp)
    xn, nd, rows, lt = c["xn"], c["nd"], c["rows"], c["lengths"]
    names, max_steps = c["names"], c["max_steps"]
    sts, szs, ns, oks = tb.walk(xn, nd, rows, lt, max_steps)  # plain

    sel = np.pad(xn[rows.long()].numpy(), ((0, 0), (1, 0)))
    nsel = np.pad(nd[rows.long()].numpy(), ((0, 0), (1, 0), (0, 0)))
    rs, rz, rn, rok = ref_tb._unzip_batch_jit(
        jnp.asarray(sel), jnp.asarray(nsel), jnp.asarray(lt.numpy()),
        max_steps=max_steps)
    assert np.array_equal(ns.numpy(), np.asarray(rn))
    assert np.array_equal(oks.numpy().astype(bool), np.asarray(rok))
    for b in range(len(names)):
        n = int(ns[b])
        assert np.array_equal(sts[b, :n].numpy().view(np.uint16),
                              np.asarray(rs)[b, :n]), names[b]
        assert np.array_equal(szs[b, :n].numpy(), np.asarray(rz)[b, :n])

    ends = {"overflow", "underflow", "empty"}
    assert [bool(o) for o in oks] == [n not in ends for n in names]
    assert int(ns[names.index("overflow")]) == max_steps
    assert int(ns[names.index("underflow")]) == 2
    assert int(ns[names.index("empty")]) == 0
    tb.REWALKS["survivors"] = 0
    out = assemble_walk_cases(c, (sts, szs, ns, oks))
    assert tb.REWALKS["survivors"] == 1  # the overflow
    assert len(out) == len(names) - 2  # all but the underflow and empty
    for b, (sid, sz) in out.items():
        r, L = int(rows[b]), int(lt[b])
        x, n = tb.host_trellis(xn[r].numpy(), nd[r].numpy(), L)
        want = tb.unzip(x, n, L, Kp)
        assert want == ref_tb.unzip(x, n, L, Kp) == c["paths"][b], names[b]
        assert list(zip(sid.tolist(), sz.tolist())) == want, names[b]
    b = names.index("underflow")
    r = int(rows[b])
    x, n = tb.host_trellis(xn[r].numpy(), nd[r].numpy(), 2)
    with pytest.raises(RuntimeError):
        tb.unzip(x, n, 2, Kp)
    with pytest.raises(RuntimeError):
        tb.rewalk(xn, nd, [r], [2], max_steps)


def test_walk_overflow_falls_back_to_host_unzip():
    """Walks that overflow their first max_steps are walked again, with
    doubled steps on the trellis's device, and equal the host oracle."""
    xn, nd, lens = trellis(40, 140)
    Kp = nd.shape[2]
    rows = torch.tensor([0, 2, 1], dtype=torch.int32)
    lt = torch.tensor([lens[0], lens[2], lens[1]], dtype=torch.int32)
    sts, szs, ns, oks = tb.walk(xn, nd, rows, lt, max_steps=8)
    assert not oks.any()
    assert (ns == 8).all()
    items = [object(), object(), object()]
    out = {}
    tb.REWALKS["survivors"] = 0
    launches = vk.LAUNCHES["walk"]
    tb.assemble_path_entries(
        [(items, sts, szs, ns, oks, xn, nd, rows.tolist(), lt.tolist())],
        [a.numpy() for a in (sts, szs, ns, oks)], out)
    assert tb.REWALKS["survivors"] == 3
    assert vk.LAUNCHES["walk"] == launches  # CPU tensors: no kernel
    for b, r in enumerate(rows.tolist()):
        x, n = tb.host_trellis(xn[r].numpy(), nd[r].numpy(), lens[r])
        sid, sz = out[id(items[b])]
        assert list(zip(sid.tolist(), sz.tolist())) == tb.unzip(
            x, n, lens[r], Kp)


def test_rewalk_raises_on_underflow():
    """A walk that cannot end at stage 0 is a corrupt trellis."""
    xn, nd, lens = trellis(40, 140)
    bad = xn.clone()
    bad[0] = (4 << 21) | (1 << 25)  # T <- C, and C claims 5 nt at stage 2
    with pytest.raises(RuntimeError):
        tb.rewalk(bad, nd, [0], [2], max_steps=8)


def test_walk_zero_length_and_bad_inputs():
    xn, nd, lens = trellis(40, 140)
    rows = torch.tensor([6], dtype=torch.int32)
    sts, szs, ns, oks = tb.walk(xn, nd, rows, torch.zeros(1, dtype=torch.int32),
                                max_steps=16)
    assert int(ns[0]) == 0 and int(oks[0]) == 0
    with pytest.raises(ValueError):
        tb.walk(xn.long(), nd, rows, torch.zeros(1, dtype=torch.int32), 16)


def test_path_arrays_and_unzip_underflow():
    sid, sz = tb.path_arrays([(1, 0), (2, 3)])
    assert sid.dtype == np.int64 and sid.tolist() == [1, 2]
    assert sz.tolist() == [0, 3]
    # a C state that claims 5 nucleotides at stage 2 underflows
    x = np.array([0, 0, (4 << 21) | (1 << 25)], np.uint32)
    n = np.zeros((3, 4), np.uint16)
    with pytest.raises(RuntimeError):
        tb.unzip(x, n, 2, 4)
