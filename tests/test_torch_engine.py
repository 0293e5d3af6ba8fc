"""Port parity of the lax.scan engine's counterpart: ops/viterbi_torch.py
and ops/engine.py against deciphon_tpu's viterbi_jax and engine (scores
and trellis bits, bit for bit), TorchPairScorer against JaxPairScorer, and
Scanner(engine="torch") products against the reference's engine="jax"."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deciphon_tpu.ops import engine as r_engine
from deciphon_tpu.ops import viterbi_jax as vj
from deciphon_tpu.ops.costs import ViterbiCosts, build_costs
from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan import pipeline as ref_pipeline
from deciphon_tpu.scan import scheduler as r_sched
from deciphon_tpu.scan.sequence import Sequence, frag_codes_ending
from deciphon_tpu.scan.window import Window
from deciphon_tpu.xtrans import xtrans_cost_vector
from deciphon_tpu_torch.convert import (costs_from_arrays,
                                        frame_profile_from_arrays,
                                        profile_pack_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.ops import engine as t_engine
from deciphon_tpu_torch.ops import viterbi_torch as vt
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as t_sched
from deciphon_tpu_torch.workload import planted_read, random_bases

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

B, L = 4, 40  # windows per batch and padded length (one compiled shape)


def windows(rng, mh, h3c, lens=(40, 31, 1, 22)):
    """(xt (B, 13), codes (B, L, 5), lengths (B,)) of random reads."""
    codes = np.zeros((B, L, 5), np.int32)
    xt = np.zeros((B, 13), np.float32)
    for b, n in enumerate(lens):
        seq = rng.integers(0, 4, size=n).astype(np.int8)
        codes[b, :n] = frag_codes_ending(seq)
        xt[b] = xtrans_cost_vector(mh, h3c, n)
    return xt, codes, np.asarray(lens, np.int32)


def tie_costs(mh, h3c) -> ViterbiCosts:
    """Costs rounded to whole numbers, so that candidates tie all the
    time, with +inf match emissions on a third of the table rows and +inf
    null/background costs on a few, so that whole M rows and special
    states are +inf at some positions (every candidate ties at +inf)."""
    c = build_costs(sample_profile(21, 12), mh, h3c)
    match = np.round(c.match)
    match[::3] = np.inf
    null, bg = np.round(c.null), np.round(c.background)
    null[::7] = np.inf
    bg[1::5] = np.inf
    return ViterbiCosts(K=c.K, core=np.round(c.core), match=match,
                        null=null, background=bg, xt=c.xt)


def as_t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def same(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mh,h3c", [(True, False), (False, True)])
@pytest.mark.parametrize("kind", ["sampled", "ties"])
def test_viterbi_family_bit_equal_to_jax(mh, h3c, kind):
    """Scores and trellis bits (int32 planes against the reference's
    uint32/uint16 as int64) of viterbi, viterbi_batch, viterbi_path_batch,
    viterbi_null and viterbi_null_batch."""
    c = (build_costs(sample_profile(11, 17), mh, h3c) if kind == "sampled"
         else tie_costs(mh, h3c))
    xt, codes, lens = windows(np.random.default_rng(5), mh, h3c)
    ref = [jnp.asarray(a) for a in (c.core, c.match, c.null, c.background)]
    port = as_t(c.core, c.match, c.null, c.background)
    T, xn, nd = vj.viterbi_path_batch(*ref, jnp.asarray(xt),
                                      jnp.asarray(codes), jnp.asarray(lens))
    T2, xn2, nd2 = vt.viterbi_path_batch(*port, *as_t(xt, codes, lens))
    assert xn2.dtype == nd2.dtype == torch.int32
    assert same(T, T2.numpy())
    assert same(np.asarray(xn).astype(np.int64), xn2.numpy())
    assert same(np.asarray(nd).astype(np.int64), nd2.numpy())
    assert not xn2[:, 0].any() and not nd2[:, 0].any()
    if kind == "ties":
        assert np.isinf(np.asarray(T)).any() or (nd2[:, 1:] == 4).any()
    assert same(vj.viterbi_batch(*ref, jnp.asarray(xt), jnp.asarray(codes),
                                 jnp.asarray(lens)),
                vt.viterbi_batch(*port, *as_t(xt, codes, lens)).numpy())
    # one window, score and path mode
    b = 1
    one = as_t(xt[b], codes[b])
    t1 = vt.viterbi(*port, *one, int(lens[b]))
    assert same(t1.numpy(), T[b])
    t1, x1, n1 = vt.viterbi(*port, *one, int(lens[b]), path=True)
    assert same(x1.numpy(), np.asarray(xn[b]).astype(np.int64))
    assert same(n1.numpy(), np.asarray(nd[b]).astype(np.int64))
    # null model
    rr = np.float32(xt[0, 0])
    want = vj.viterbi_null_batch(jnp.asarray(c.null), jnp.float32(rr),
                                 jnp.asarray(codes), jnp.asarray(lens))
    got = vt.viterbi_null_batch(port[2], rr, *as_t(codes, lens))
    assert same(want, got.numpy())
    assert same(vj.viterbi_null(jnp.asarray(c.null), jnp.float32(rr),
                                jnp.asarray(codes[b]), int(lens[b])),
                vt.viterbi_null(port[2], rr, as_t(codes[b])[0],
                                int(lens[b])).numpy())


@pytest.mark.parametrize("mh,h3c", [(True, False), (False, True)])
def test_profile_pack_and_scan_scores_bit_equal(mh, h3c):
    """ProfilePack at 128 lanes (pad lanes past every K: the recomputed
    DDCUM row stays finite), scan_scores bit for bit, lrt_tile."""
    costs = [build_costs(sample_profile(s, k), mh, h3c)
             for s, k in [(1, 5), (2, 12), (3, 9)]]
    want = r_engine.ProfilePack.from_costs(costs)
    got = t_engine.ProfilePack.from_costs(
        [costs_from_arrays(**vars(c)) for c in costs])
    again = profile_pack_from_arrays(**vars(want))
    assert got.K_pad == want.K_pad == again.K_pad == 128
    for f in ("core", "match", "null", "background", "core_sizes"):
        assert same(getattr(got, f), getattr(want, f))
        assert same(getattr(again, f), getattr(want, f))
        assert getattr(again, f) is not getattr(want, f)
    assert np.isfinite(got.core[:, 8]).all()
    xt, codes, lens = windows(np.random.default_rng(8), mh, h3c)
    nul, alt = r_engine.scan_scores_jit(
        *(jnp.asarray(a) for a in (want.core, want.match, want.null,
                                   want.background, xt, codes, lens)))
    nul2, alt2 = t_engine.scan_scores(*as_t(got.core, got.match, got.null,
                                            got.background),
                                      *as_t(xt, codes, lens))
    assert nul2.shape == alt2.shape == (3, B)
    assert same(nul, nul2.numpy()) and same(alt, alt2.numpy())
    assert same(r_engine.lrt_tile(nul, alt),
                t_engine.lrt_tile(nul2, alt2).numpy())


def pair_items(sched, rng):
    """Three windows of each of three profiles (as test_pallas.py's
    bucketed-scorer case)."""
    items = []
    for p_idx in range(3):
        for w in range(3):
            n = 30 + 7 * w
            seq = rng.integers(0, 4, size=n).astype(np.int8)
            items.append(sched.PairItem(
                p_idx=p_idx, s_idx=w, win=Window(idx=w, start=0, stop=n)
                if sched is r_sched else _p_window(w, n),
                codes=frag_codes_ending(seq), multi_hits=True,
                hmmer3_compat=False))
    return items


def _p_window(idx, n):
    from deciphon_tpu_torch.scan.window import Window as PWindow

    return PWindow(idx=idx, start=0, stop=n)


def test_torch_pair_scorer_matches_jax_pair_scorer():
    costs = [build_costs(sample_profile(s, k))
             for s, k in [(1, 6), (2, 150), (3, 9)]]
    r_items = pair_items(r_sched, np.random.default_rng(5))
    p_items = pair_items(t_sched, np.random.default_rng(5))
    want = r_sched.JaxPairScorer(costs).score(r_items)
    got = t_sched.TorchPairScorer([costs_from_arrays(**vars(c))
                                   for c in costs], "cpu").score(p_items)
    assert len(got) == len(want) == 9
    for a, b in zip(p_items, r_items):
        assert got[id(a)] == want[id(b)]


@pytest.fixture(scope="module")
def planted():
    """Two profiles (K 40 and 150) and three reads, two carrying a
    planted domain: one survivor of each profile in the same wave."""
    ref_profiles = [sample_profile(140, 40), sample_profile(250, 150)]
    profiles = [frame_profile_from_arrays(**vars(p)) for p in ref_profiles]
    rng = np.random.default_rng(7)
    reads = [planted_read(rng, profiles[0], 300),
             random_bases(rng, 250),
             planted_read(rng, profiles[1], 480, noise=0.01)]
    ref_seqs = [Sequence.make(i, f"r{i}", r) for i, r in enumerate(reads)]
    seqs = [sequence_from_arrays(**vars(s)) for s in ref_seqs]
    return (ref_profiles, ref_seqs), (profiles, seqs)


@pytest.fixture(scope="module")
def jax_products(planted, tmp_path_factory):
    """The reference's engine="jax" products per flag pair, run once."""
    (ref_profiles, ref_seqs), _ = planted
    out = {}
    for mh, h3c in [(True, False), (False, True)]:
        ref = ref_pipeline.Scanner(ref_profiles, ref_pipeline.ScanConfig(
            engine="jax", multi_hits=mh, hmmer3_compat=h3c))
        tmp = tmp_path_factory.mktemp("jax")
        with open(ref.run(ref_seqs, str(tmp)), "rb") as fp:
            out[(mh, h3c)] = (fp.read(), ref.metrics)
    return out


def run_port(profiles, seqs, tmp, engine, **flags):
    sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu", engine=engine,
                                            **flags))
    with open(sc.run(seqs, str(tmp)), "rb") as fp:
        return fp.read(), sc


@pytest.mark.parametrize("mh,h3c", [(True, False), (False, True)])
def test_torch_engine_products_byte_identical(planted, jax_products,
                                              tmp_path, mh, h3c):
    """engine="torch" writes engine="jax"'s bytes and the "kernels"
    engine's, through waves scored at dispatch and its own phase 2."""
    _, (profiles, seqs) = planted
    want, ref_metrics = jax_products[(mh, h3c)]
    got, sc = run_port(profiles, seqs, tmp_path / "torch", "torch",
                       multi_hits=mh, hmmer3_compat=h3c)
    assert isinstance(sc.scorer, t_sched.TorchPairScorer)
    assert sc.metrics.survivors == ref_metrics.survivors > 0
    assert sc.metrics.products == ref_metrics.products > 0
    assert got == want
    kernels, _ = run_port(profiles, seqs, tmp_path / "kernels", "kernels",
                          multi_hits=mh, hmmer3_compat=h3c)
    assert kernels == got


def test_torch_engine_early_collect(planted, jax_products, tmp_path,
                                    monkeypatch):
    """PATH_BATCH_BYTES below one group's trellis: every path launch but
    the last is collected early, and the products stay the same."""
    _, (profiles, seqs) = planted
    early, collected = [], []
    orig_fetch = t_sched.fetch_steps
    orig_collect = tp.Scanner._batched_paths_collect

    def spy_fetch(entries):
        early.append(len(entries))
        return orig_fetch(entries)

    def spy_collect(self, entries):
        collected.append(len(entries))
        return orig_collect(self, entries)

    monkeypatch.setattr(t_sched.TorchPairScorer, "PATH_BATCH_BYTES", 1)
    monkeypatch.setattr(t_sched, "fetch_steps", spy_fetch)
    monkeypatch.setattr(tp.Scanner, "_batched_paths_collect", spy_collect)
    got, sc = run_port(profiles, seqs, tmp_path, "torch", max_pairs=4)
    assert got == jax_products[(True, False)][0]
    # the wave's two survivors are two path groups: the scorer collects
    # the first early, the pipeline the second with the wave (one entry
    # and the dict of the early results)
    assert sc.metrics.survivors == 2 and sc.metrics.pairs_batches == 1
    assert early == [1]
    assert collected == [2]


def test_engine_choice():
    profiles = [frame_profile_from_arrays(**vars(sample_profile(1, 9)))]
    with pytest.raises(ValueError, match="engine"):
        tp.Scanner(profiles, tp.ScanConfig(device="cpu", engine="pallas"))
    sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu", engine="torch"))
    assert isinstance(sc.scorer, t_sched.TorchPairScorer)
    assert sc.scorer.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.Scanner(profiles, tp.ScanConfig(engine="torch"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_sched.TorchPairScorer([], "cuda")
