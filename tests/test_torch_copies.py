"""The port's own copies of deciphon_tpu's host modules behave as the
originals: the same seeded numpy inputs through the reference function and
through the port's copy give equal results.  Exact equality, no tolerance;
one parametrised test per module.
"""

import dataclasses
import inspect
import json
import io
import logging
from pathlib import Path

import numpy as np
import pytest

import deciphon_tpu.alphabet as r_alphabet
import deciphon_tpu.frame as r_frame
import deciphon_tpu.gencode as r_gencode
import deciphon_tpu.hmmer.client as r_client
import deciphon_tpu.hmmer.daemon as r_daemon
import deciphon_tpu.hmmer.h3result as r_h3result
import deciphon_tpu.hmmer.wire as r_wire
import deciphon_tpu.hmmfile as r_hmmfile
import deciphon_tpu.logging as r_logging
import deciphon_tpu.ops.costs as r_costs
import deciphon_tpu.parallel.multihost as r_multihost
import deciphon_tpu.profile as r_profile
import deciphon_tpu.scan.decoder as r_decoder
import deciphon_tpu.scan.product as r_product
import deciphon_tpu.scan.scheduler as r_sched
import deciphon_tpu.scan.sequence as r_sequence
import deciphon_tpu.scan.window as r_window
import deciphon_tpu.states as r_states
import deciphon_tpu.xtrans as r_xtrans
import deciphon_tpu_torch.alphabet as p_alphabet
import deciphon_tpu_torch.frame as p_frame
import deciphon_tpu_torch.gencode as p_gencode
import deciphon_tpu_torch.hmmer.client as p_client
import deciphon_tpu_torch.hmmer.daemon as p_daemon
import deciphon_tpu_torch.hmmer.h3result as p_h3result
import deciphon_tpu_torch.hmmer.wire as p_wire
import deciphon_tpu_torch.hmmfile as p_hmmfile
import deciphon_tpu_torch.logging as p_logging
import deciphon_tpu_torch.ops.costs as p_costs
import deciphon_tpu_torch.parallel.multihost as p_multihost
import deciphon_tpu_torch.profile as p_profile
import deciphon_tpu_torch.scan.decoder as p_decoder
import deciphon_tpu_torch.scan.product as p_product
import deciphon_tpu_torch.scan.scheduler as p_sched
import deciphon_tpu_torch.scan.sequence as p_sequence
import deciphon_tpu_torch.scan.window as p_window
import deciphon_tpu_torch.states as p_states
import deciphon_tpu_torch.xtrans as p_xtrans
from deciphon_tpu_torch.convert import (costs_from_arrays,
                                        frame_profile_from_arrays,
                                        sequence_from_arrays)


def same(a, b) -> bool:
    """Equal values of equal types, arrays with equal dtype and shape."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=True))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


def same_fields(a, b) -> bool:
    fa = [f.name for f in dataclasses.fields(a)]
    return (fa == [f.name for f in dataclasses.fields(b)]
            and all(same(getattr(a, f), getattr(b, f)) for f in fa))


@pytest.mark.parametrize("what", ["constants", "codes", "tables",
                                  "emission"])
def test_frame_copy(what):
    if what == "constants":
        assert p_frame.TABLE_SIZE == r_frame.TABLE_SIZE == 1364
        assert same(p_frame.FRAG_OFFSETS, r_frame.FRAG_OFFSETS)
    elif what == "codes":
        rng = np.random.default_rng(1)
        for _ in range(50):
            syms = tuple(rng.integers(0, 4, size=rng.integers(1, 6)).tolist())
            c = p_frame.frag_code(syms)
            assert c == r_frame.frag_code(syms)
            assert p_frame.frag_symbols(c) == r_frame.frag_symbols(c) == syms
            assert p_frame.frag_len(c) == r_frame.frag_len(c) == len(syms)
    elif what == "tables":
        assert same(p_frame._term_tables(), r_frame._term_tables())
        assert same(p_frame.match_pattern_matrix(),
                    r_frame.match_pattern_matrix())
        assert same(p_frame._di_class_logconst(0.1),
                    r_frame._di_class_logconst(0.1))
        assert same(p_frame.emission_feature_matrix(0.05),
                    r_frame.emission_feature_matrix(0.05))
    else:
        rng = np.random.default_rng(2)
        p = rng.random((3, 4, 4, 4))
        lp = np.log(p / p.sum(axis=(1, 2, 3), keepdims=True))
        assert same(p_frame.emission_table(lp, 0.1),
                    r_frame.emission_table(lp, 0.1))
        assert same(p_frame.nuclt_marginal_lprobs(lp),
                    r_frame.nuclt_marginal_lprobs(lp))
        assert same(p_frame.codon_marginals(lp[0]),
                    r_frame.codon_marginals(lp[0]))
        q = p_frame.nuclt_marginal_lprobs(lp[0])
        assert same(p_frame.conditional_emission_table(0.1, q),
                    r_frame.conditional_emission_table(0.1, q))


@pytest.mark.parametrize("mh,h3c", [(True, False), (False, True),
                                    (True, True), (False, False)])
def test_xtrans_copy(mh, h3c):
    for n in (1, 2, 37, 450, 10_000, 100_000):
        assert same(p_xtrans.xtrans_cost_vector(mh, h3c, n),
                    r_xtrans.xtrans_cost_vector(mh, h3c, n))
        assert same(p_xtrans.xtrans_costs(p_xtrans.xtrans_setup(mh, h3c, n)),
                    r_xtrans.xtrans_costs(r_xtrans.xtrans_setup(mh, h3c, n)))
    names = [n for n in dir(r_xtrans) if n.startswith("XT_")]
    assert names and all(getattr(p_xtrans, n) == getattr(r_xtrans, n)
                         for n in names)


def test_states_copy():
    names = [n for n in dir(r_states) if n.startswith("STATE_")]
    assert names and all(getattr(p_states, n) == getattr(r_states, n)
                         for n in names)
    ids = [getattr(r_states, n) for n in names
           if isinstance(getattr(r_states, n), int)]
    for k in (0, 1, 7, 2000, 16383):
        ids += [r_states.make_match_id(k), r_states.make_insert_id(k),
                r_states.make_delete_id(k)]
        assert p_states.make_match_id(k) == r_states.make_match_id(k)
        assert p_states.make_insert_id(k) == r_states.make_insert_id(k)
        assert p_states.make_delete_id(k) == r_states.make_delete_id(k)
    special = [sid for sid in ids if (sid >> 14) == 3 and sid < (1 << 16)]
    for sid in ids:
        for fn in ("state_class", "is_match", "is_insert", "is_delete",
                   "is_core", "is_mute"):
            assert getattr(p_states, fn)(sid) == getattr(r_states, fn)(sid)
        if (sid >> 14) != 3 or sid in special:
            try:
                want = r_states.state_name(sid)
            except Exception as exc:  # the copy fails the same way
                with pytest.raises(type(exc)):
                    p_states.state_name(sid)
            else:
                assert p_states.state_name(sid) == want


@pytest.mark.parametrize("raw", ["ACGTACGT", "acgtnnry", "ACGUUGCA",
                                 "AcGtWSKMBDHVN", "ACGTU", "ACGX", ""])
def test_alphabet_and_sequence_copy(raw):
    """Symbols incl. IUPAC disambiguation and T/U handling; a sequence's
    symbols, codes and window codes."""
    try:
        want = r_alphabet.prepare_sequence(raw)
    except r_alphabet.InvalidSequenceError as exc:
        ptype = getattr(p_alphabet, type(exc).__name__)
        with pytest.raises(ptype):
            p_alphabet.prepare_sequence(raw)
        assert issubclass(p_alphabet.MixedTUError,
                          p_alphabet.InvalidSequenceError)
        return
    assert same(p_alphabet.prepare_sequence(raw), want)
    assert p_alphabet.disambiguate(raw) == r_alphabet.disambiguate(raw)
    rs = r_sequence.Sequence.make(3, "s", raw)
    ps = p_sequence.Sequence.make(3, "s", raw)
    assert same_fields(ps, rs)
    assert same_fields(sequence_from_arrays(**vars(rs)), rs)
    assert ps.size == rs.size
    if rs.size >= 4:
        assert same(ps.window_codes(1, rs.size - 1),
                    rs.window_codes(1, rs.size - 1))
        assert same(p_sequence.frag_codes_ending(ps.symbols),
                    r_sequence.frag_codes_ending(rs.symbols))


@pytest.mark.parametrize("gid", [1, 4, 11])
def test_gencode_copy(gid):
    pg, rg = p_gencode.get_gencode(gid), r_gencode.get_gencode(gid)
    assert same(pg.amino_idx, rg.amino_idx)
    for z in range(64):
        assert pg.decode(z) == rg.decode(z)
        assert p_gencode.codon_symbols(z) == r_gencode.codon_symbols(z)
    assert p_gencode.codon_index(1, 2, 3) == r_gencode.codon_index(1, 2, 3)


HMM_TEXT = """HMMER3/f [3.3 | Nov 2019]
NAME  tiny
ACC   PF00000.1
LENG  2
ALPH  amino
GA    21.00 20.00;
HMM          A        C        D        E        F        G        H        I        K        L        M        N        P        Q        R        S        T        V        W        Y
            m->m     m->i     m->d     i->m     i->i     d->m     d->d
  COMPO   2.5 4.0 2.9 2.7 3.4 2.8 3.7 2.9 2.7 2.4 3.7 3.1 3.3 3.1 2.9 2.6 2.8 2.6 4.5 3.4
          2.6 4.4 2.7 2.6 3.3 2.8 3.7 2.9 2.7 2.4 3.7 3.1 3.3 3.1 2.9 2.6 2.8 2.6 4.5 3.4
          0.1 3.0 3.5 0.6 0.8 0.0 *
      1   2.9 4.7 3.1 2.6 3.6 3.4 3.8 2.8 2.5 2.3 3.6 3.0 3.9 2.9 2.8 2.7 2.8 2.5 5.0 3.6      1 k - - -
          2.6 4.4 2.7 2.6 3.3 2.8 3.7 2.9 2.7 2.4 3.7 3.1 3.3 3.1 2.9 2.6 2.8 2.6 4.5 3.4
          0.1 3.0 3.5 0.6 0.8 0.5 0.9
      2   2.4 4.6 3.0 2.5 3.9 2.9 3.7 3.4 2.4 2.9 3.9 3.0 3.6 2.9 2.8 2.5 2.7 2.9 5.3 3.9      2 a - - -
          2.6 4.4 2.7 2.6 3.3 2.8 3.7 2.9 2.7 2.4 3.7 3.1 3.3 3.1 2.9 2.6 2.8 2.6 4.5 3.4
          0.0 * * 0.6 0.8 0.0 *
//
"""


@pytest.mark.parametrize("what", ["constants", "parse", "press"])
def test_hmmfile_and_profile_copy(what):
    if what == "constants":
        for n in ("NUM_AMINO", "NUM_TRANS", "T_MM", "T_MI", "T_MD", "T_IM",
                  "T_II", "T_DM", "T_DD"):
            assert getattr(p_hmmfile, n) == getattr(r_hmmfile, n)
        assert same(p_profile.NULL_AMINO_LPROBS, r_profile.NULL_AMINO_LPROBS)
        return
    ph = p_hmmfile.read_hmm(io.StringIO(HMM_TEXT))
    rh = r_hmmfile.read_hmm(io.StringIO(HMM_TEXT))
    assert len(ph) == len(rh) == 1
    assert same_fields(ph[0], rh[0])
    if what == "press":
        for dist in (p_profile.ENTRY_DIST_UNIFORM,
                     p_profile.ENTRY_DIST_OCCUPANCY):
            assert same_fields(p_profile.press_profile(ph[0], 1, 0.01, dist),
                               r_profile.press_profile(rh[0], 1, 0.01, dist))
    with pytest.raises(p_hmmfile.HMMFileError):
        p_hmmfile.read_hmm(io.StringIO("not an hmm\n"))


@pytest.mark.parametrize("seed,K", [(1, 9), (140, 40), (250, 150),
                                    (7, 600)])
def test_sample_profile_and_costs_copy(seed, K):
    rp = r_profile.sample_profile(seed, K)
    pp = p_profile.sample_profile(seed, K)
    assert same_fields(pp, rp)
    assert same_fields(frame_profile_from_arrays(**vars(rp)), rp)
    for mh, h3c in ((True, False), (False, True)):
        rc = r_costs.build_costs(rp, mh, h3c)
        pc = p_costs.build_costs(pp, mh, h3c)
        assert same_fields(pc, rc)
        assert same_fields(costs_from_arrays(**vars(rc)), rc)
        assert same_fields(pc.with_xtrans(mh, h3c, 777),
                           rc.with_xtrans(mh, h3c, 777))
    assert same(p_costs.dd_cum_row(pc.core[p_costs.CT_DD]),
                r_costs.dd_cum_row(rc.core[r_costs.CT_DD]))
    with pytest.raises(ValueError):
        costs_from_arrays(**dict(vars(rc), null=rc.null[:10]))


def walk_windows(mod, K, n, hits):
    """Every window of a cursor's walk; `hits` maps a window index to the
    hit position fed back after it."""
    cur = mod.WindowCursor(K, n)
    out = [("estimate", cur.estimate_windows())]
    while True:
        w = cur.next()
        if w is None:
            return out
        out.append((w.idx, w.start, w.stop, w.length, cur.state()))
        if w.idx in hits:
            cur.set_last_hit_position(hits[w.idx])
        if w.idx == 1:  # a save and restore round trip
            st = cur.state()
            cur.next()
            cur.restore(st)


@pytest.mark.parametrize("K,n,hits", [
    (9, 300, {}), (9, 2000, {}), (9, 2000, {0: 400, 2: 30}),
    (40, 10_000, {1: 1999}), (2000, 40_000, {}), (2500, 250_000, {0: 5}),
    (5, 1, {}),
])
def test_window_cursor_copy(K, n, hits):
    assert walk_windows(p_window, K, n, hits) == walk_windows(r_window, K, n,
                                                              hits)


@pytest.mark.parametrize("seed,K", [(140, 40), (109, 9)])
def test_decoder_copy(seed, K):
    rp = r_profile.sample_profile(seed, K)
    pp = frame_profile_from_arrays(**vars(rp))
    rd, pd = r_decoder.Decoder(rp), p_decoder.Decoder(pp)
    rng = np.random.default_rng(seed)
    sids = ([r_states.make_match_id(int(k)) for k in rng.integers(0, K, 40)]
            + [r_states.make_insert_id(int(k))
               for k in rng.integers(0, K, 10)]
            + [r_states.STATE_N, r_states.STATE_C, r_states.STATE_J])
    fcs = rng.integers(0, 1364, size=len(sids))
    want = rd.decode_batch(sids, fcs)
    assert pd.decode_batch(sids, fcs) == want
    assert pd.decode_batch(sids, fcs) == want  # from the memo plane
    for sid, fc in list(zip(sids, fcs))[:8]:
        assert pd.decode(sid, int(fc)) == rd.decode(sid, int(fc))
        assert (pd.decode_codon_amino(sid, int(fc))
                == rd.decode_codon_amino(sid, int(fc)))


def write_products(mod, d, checkpoint):
    w = mod.ProductWriter(str(d))
    lines = [mod.ProductLine(
        sequence=s, window=wi, window_start=10 * wi, window_stop=10 * wi + 90,
        hit=0, hit_start=3, hit_stop=60, profile=f"PF{s:05d}.1", abc="dna",
        lrt=12.5 + wi / 3, logevalue=-3.25 * s,
        steps=["ACG,M1,ACG,T", "T,I1,,", ",E,,"])
        for s, wi in [(2, 1), (0, 0), (1, 3), (0, 2)]]
    for i, ln in enumerate(lines):
        order = (ln.sequence, ln.window, i)
        w.add(ln, order=order)
        if checkpoint:
            w.journal_line(ln, order, (ln.sequence, 0))
            w.journal_pair_done(ln.sequence, 0)
    w.add_h3r(lines[0], b"\x01\x02blob")
    if checkpoint:
        w2 = mod.ProductWriter(str(d))
        done = w2.load_checkpoint()
        assert done == {(0, 0), (1, 0), (2, 0)}
        assert [ln.render() for ln in w2.lines] == [
            ln.render() for ln in w.lines]
    w.sort_lines()
    path = w.close()
    with open(path, "rb") as fp:
        return fp.read(), mod.fletcher16(path), sorted(
            p.name for p in d.rglob("*"))


@pytest.mark.parametrize("checkpoint", [False, True])
def test_product_writer_copy(tmp_path, checkpoint):
    got = write_products(p_product, tmp_path / "port", checkpoint)
    want = write_products(r_product, tmp_path / "ref", checkpoint)
    assert got == want and got[0].count(b"\n") == 5
    for v in (0.0, -1.5, -745.2, 3.0):
        assert p_product.format_evalue(v) == r_product.format_evalue(v)
        assert p_product.format_lrt(v) == r_product.format_lrt(v)


def test_scan_metrics_copy():
    pm, rm = p_logging.ScanMetrics(), r_logging.ScanMetrics()
    for m in (pm, rm):
        m.add_window(300, 40)
        m.add_window(1200, 9)
        m.add_wall("pack", 0.25)
        m.add_wall("pack", 0.5)
        m.add_bucket_cells("b", 10, 20)
        m.survivors += 2
        with m.timed("write"):
            pass
    ps, rs = pm.summary(), rm.summary()
    for k in ("windows_scored", "cells", "pairs_batches", "survivors",
              "products", "wasted_windows"):
        assert ps[k] == rs[k]
    assert ps.keys() == rs.keys()
    assert ps["walls"].keys() == rs["walls"].keys()
    assert ps["walls"]["pack"] == rs["walls"]["pack"] == 0.75
    assert pm.bucket_cells == rm.bucket_cells
    assert isinstance(p_logging.get_logger("x.y"), logging.Logger)


def make_items(mod, win_mod, rng, n_items, n_profiles):
    """Items with random window lengths (no reads: the helpers only read
    the window and the indices)."""
    items = []
    for i in range(n_items):
        L = int(rng.integers(1, 30_000) if i % 3 else rng.integers(1, 400))
        items.append(mod.PairItem(
            p_idx=int(rng.integers(0, n_profiles)), s_idx=i,
            win=win_mod.Window(i % 4, 5 * i, 5 * i + L), multi_hits=True,
            hmmer3_compat=False, gstart=7 * i))
    return items


def batches_key(buckets):
    return [(b.nlb, b.w, [[(it.p_idx, it.s_idx, it.win.start, it.win.stop)
                           for it in g] for g in b.groups])
            for b in buckets]


class _Codes:
    pad_start = 123_456


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_helpers_copy(seed):
    rng = np.random.default_rng(seed)
    for n in rng.integers(0, 5000, size=40).tolist() + [0, 1, 4200, 4201]:
        assert p_sched.quantize_nlb(n) == r_sched.quantize_nlb(n)
        assert p_sched.next_pow2(n) == r_sched.next_pow2(n)
        assert p_sched.prev_pow2(n) == r_sched.prev_pow2(n)
        assert p_sched.chunk_sizes(n) == r_sched.chunk_sizes(n)
        assert p_sched.pad_groups(min(n, 64)) == r_sched.pad_groups(min(n, 64))
    assert p_sched.NCHUNK == r_sched.NCHUNK and p_sched.W == r_sched.W
    blks = np.sort(rng.integers(1, 600, size=int(rng.integers(1, 200))))
    assert p_sched._mass_p90(blks) == r_sched._mass_p90(blks)

    state = rng.bit_generator.state
    p_items = make_items(p_sched, p_window, rng, 150, 7)
    rng.bit_generator.state = state
    r_items = make_items(r_sched, r_window, rng, 150, 7)
    for kappa, w, floor in ((40, 8, 1), (40, 64, 32), (32, 8, 1)):
        pb = p_sched.build_batches(p_items, kappa, w=w, nlb_floor=floor)
        rb = r_sched.build_batches(r_items, kappa, w=w, nlb_floor=floor)
        assert batches_key(pb) == batches_key(rb)
        for a, b in zip(pb[:3], rb[:3]):
            assert same(list(p_sched.bucket_arrays_meta(a, _Codes)),
                        list(r_sched.bucket_arrays_meta(b, _Codes)))
    assert same(p_items[0].xt, r_items[0].xt)

    wins = [(i, int(b)) for i, b in enumerate(
        np.sort(rng.integers(1, 40, size=60))[::-1])]
    for nslots, cap, cmax in ((8, 40, 4), (2, 64, float("inf")),
                              (16, 39, 2)):
        assert (p_sched._lpt_pack(wins, nslots, cap, cmax)
                == r_sched.PairScorer._lpt_pack(wins, nslots, cap, cmax))

    sizes = rng.integers(1, 1000, size=12).tolist()
    for budget in (0, 500, 3000, 10**6):
        pl, rl = p_sched.HBMLedger(budget), r_sched.HBMLedger(budget)
        assert pl.plan(sizes) == rl.plan(sizes)
        assert (pl.resident, pl.streamed) == (rl.resident, rl.streamed)
        assert pl.resident_bytes == rl.resident_bytes
        assert pl.streamed_bytes == rl.streamed_bytes


@pytest.mark.parametrize("name", ["HBM_STATE_BUDGET",
                                  "HBM_STATE_BYTES_PER_LANE", "MAX_KP"])
def test_large_k_constants_copy(name):
    """The large-K tier's copied constants: the slot-width budget of the
    reference's `hbm_factory`, the HBM-table kernel's state bytes per lane
    and the widest plain bucket (the reference's MAX_PALLAS_KP)."""
    import deciphon_tpu.ops.viterbi_pallas as r_vp
    import deciphon_tpu_torch.ops.viterbi as p_vk

    want = {"HBM_STATE_BUDGET": r_sched.BucketedPairScorer.HBM_STATE_BUDGET,
            "HBM_STATE_BYTES_PER_LANE": r_vp.HBM_STATE_BYTES_PER_LANE,
            "MAX_KP": r_sched.BucketedPairScorer.MAX_PALLAS_KP}[name]
    got = {"HBM_STATE_BUDGET": p_sched.BucketedPairScorer.HBM_STATE_BUDGET,
           "HBM_STATE_BYTES_PER_LANE": p_vk.HBM_STATE_BYTES_PER_LANE,
           "MAX_KP": p_sched.BucketedPairScorer.MAX_KP}[name]
    assert same(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_arrays_and_pad_len_copy(seed):
    """The lax.scan engine's host inputs: `bucket_arrays` in its "raw"
    (END-indexed codes) and "pending" (START-indexed) forms, and the
    pipeline's phase-2 group length `_pad_len` (in the port's scheduler,
    beside the torch engine's phase 2 that uses it)."""
    import deciphon_tpu.scan.pipeline as r_pipeline

    for n in (0, 1, 63, 64, 65, 255, 256, 257, 1000, 4096, 4097, 100_000):
        assert p_sched._pad_len(n) == r_pipeline._pad_len(n)
    rng = np.random.default_rng(seed)
    p_items, r_items = [], []
    for i in range(40):
        L = int(rng.integers(1, 300))
        codes = rng.integers(0, 1364, size=(L, 5)).astype(np.int32)
        p_idx = int(rng.integers(0, 5))
        for mod, win_mod, out in ((p_sched, p_window, p_items),
                                  (r_sched, r_window, r_items)):
            out.append(mod.PairItem(
                p_idx=p_idx, s_idx=i, win=win_mod.Window(i % 3, 0, L),
                multi_hits=bool(i % 2), hmmer3_compat=not i % 2,
                codes=codes))
    for kappa, mode in ((32, "raw"), (40, "pending")):
        pb = p_sched.build_batches(p_items, kappa)
        rb = r_sched.build_batches(r_items, kappa)
        assert batches_key(pb) == batches_key(rb)
        for a, b in zip(pb, rb):
            assert same(list(p_sched.bucket_arrays(a, kappa, mode=mode)),
                        list(r_sched.bucket_arrays(b, kappa, mode=mode)))
    with pytest.raises(ValueError, match="static"):
        p_sched.bucket_arrays(pb[0], 40, mode="static")


def h3_result(mod, n_domains: int):
    """An H3Result of `mod` with a hit of n_domains domains, each with an
    alignment display."""
    doms = [mod.H3Domain(
        ienv=1 + d, jenv=40 + d, iali=2 + d, jali=38 + d, envsc=1.5,
        domcorrection=0.25, dombias=0.125, oasc=3.0, bitscore=20.0 + d,
        lnP=-12.5 - d, is_reported=True, is_included=d % 2 == 0,
        scale_per_pos=[0.5, 0.25],
        ad=mod.H3AliDisplay(presence=mod.PRESENCE_RFLINE, rfline="xx",
                            model="AC", mline="A+", aseq="AD", N=2,
                            hmmname="prof", hmmacc="PF1", hmmfrom=1,
                            hmmto=2, M=40, sqname="s", sqfrom=3, sqto=4,
                            L=50))
        for d in range(n_domains)]
    return mod.H3Result.single_hit(
        name="prof", acc="PF00001.2", score=42.5, lnP=-30.25, Z=7.0,
        qlen=40, seqlen=50, domains=doms)


@pytest.mark.parametrize("name", ["h3result", "wire", "client", "daemon"])
def test_hmmer_module_copy(name):
    """The hmmer host modules are the reference's, byte for byte (they
    import no jax), and each behaves as its original: blobs, wire replies,
    and the client against the other package's fake daemon."""
    root = Path(__file__).resolve().parent.parent
    assert ((root / "deciphon_tpu_torch" / "hmmer" / f"{name}.py").read_bytes()
            == (root / "deciphon_tpu" / "hmmer" / f"{name}.py").read_bytes())
    if name == "h3result":
        for n in (0, 1, 3):
            blob = h3_result(p_h3result, n).to_blob()
            assert blob == h3_result(r_h3result, n).to_blob()
            back = p_h3result.H3Result.from_blob(blob)
            assert back.to_blob() == blob
            assert back.targets_table() == r_h3result.H3Result.from_blob(
                blob).targets_table()
            assert back.hit_logevalue(0) == r_h3result.H3Result.from_blob(
                blob).hit_logevalue(0)
    elif name == "wire":
        for n in (0, 2):
            msg = p_wire.serialize_reply(h3_result(p_h3result, n))
            assert msg == r_wire.serialize_reply(h3_result(r_h3result, n))
            assert (p_wire.parse_reply(msg).to_blob()
                    == r_wire.parse_reply(msg).to_blob())
        with pytest.raises(p_wire.WireError):
            p_wire.parse_reply(b"\x00\x01")
    else:  # the port's client or daemon in place of the reference's
        def respond(hmmidx, seq):
            assert seq == "MAGIC" or seq == ""
            return h3_result(r_h3result, 1 if seq else 0)

        def confirm(client, daemon):
            with daemon.FakeHMMERDaemon(respond) as d, client.HMMERClient(
                    "127.0.0.1", d.port, num_proteins=7, has_ga=False) as c:
                return c.confirm(2, "MAGIC")

        want = confirm(r_client, r_daemon)
        got = (confirm(p_client, r_daemon) if name == "client"
               else confirm(r_client, p_daemon))
        assert got == want and want[0] == -30.25 + np.log(7.0)


# The library modules the port copies file for file.  Three lines differ,
# the only differences allowed: one line of io/dcp.py names an absolute
# path on the machine it was written on, and the port's copy words it
# without it; the scheduler's data directory and deciphonctl's
# configuration are the port's own, so that the two packages never share
# a sqlite file or a configuration.
# {file: [(a text only that line of the original holds, the port's line)]}.
LIBRARY_COPIES = ["intervals.py", "schema.py", "press.py", "scan/fasta_io.py",
                  "io/__init__.py", "io/dcp.py"] + [
    f"snap/{n}.py" for n in ("__init__", "match", "fasta", "gff", "hit",
                             "prod", "snap_file", "view")] + [
    "worker/__init__.py", "worker/progressor.py", "poster.py", "errors.py",
    "control.py", "ops/bruteforce.py"] + [
    f"sched/{n}.py" for n in ("__init__", "settings", "storage", "database",
                              "server")]
REWORDED = {
    "io/dcp.py": [(
        "reference/control/tests/files/minifam.dcp and validated",
        "(control/tests/files/minifam.dcp) and validated by the exact\n")],
    "sched/settings.py": [(
        "~/.local/share/deciphon_tpu/sched",
        '        "data_dir", os.path.expanduser('
        '"~/.local/share/deciphon_tpu_torch/sched")))\n')],
    "control.py": [(
        "~/.config/deciphon_tpu/deciphonctl.json",
        'CONFIG_PATH = os.path.expanduser('
        '"~/.config/deciphon_tpu_torch/deciphonctl.json")\n')]}


@pytest.mark.parametrize("rel", LIBRARY_COPIES)
def test_library_module_copy(rel):
    """press, the .dcp container, FASTA input, schema, intervals, the snap
    modules and the services' modules (scheduler, client, deciphonctl,
    errors, the progressor) and the bruteforce oracle are the reference's
    file bytes (they import no jax, and their relative imports resolve
    inside the port)."""
    root = Path(__file__).resolve().parent.parent
    lines = (root / "deciphon_tpu" / rel).read_bytes().decode().splitlines(
        keepends=True)
    for marker, new in REWORDED.get(rel, []):
        at = [i for i, ln in enumerate(lines) if marker in ln]
        assert len(at) == 1
        lines[at[0]] = new
    assert (root / "deciphon_tpu_torch" / rel).read_bytes().decode() == \
        "".join(lines)


@pytest.mark.parametrize("which", ["sample", "peaked", "inline"])
def test_hmm_text_round_trip(which):
    """read_hmm(hmm_text(h)) gives h back within 1e-5 (the 5 decimals of
    HMMER3's score columns), and the reference's parser reads the same."""
    from deciphon_tpu_torch.workload import hmm_text, peaked_hmm, sample_hmm

    if which == "sample":
        hmms = [sample_hmm(200 + i, k)[0] for i, k in enumerate((9, 50))]
    elif which == "peaked":
        hmms = [peaked_hmm(40, 9), peaked_hmm(42, 95)]
    else:
        hmms = p_hmmfile.read_hmm(io.StringIO(HMM_TEXT)) * 2
    text = hmm_text(hmms)
    back = p_hmmfile.read_hmm(io.StringIO(text))
    assert len(back) == len(hmms)
    for h, b in zip(hmms, back):
        for f in ("name", "accession", "description", "length", "alphabet",
                  "consensus", "ga", "stats"):
            assert getattr(b, f) == getattr(h, f), f
        arrays = ["match_lprobs", "trans"]
        if h.insert_lprobs is not None:
            arrays.append("insert_lprobs")
        assert (b.compo is None) == (h.compo is None)
        if h.compo is not None:
            arrays.append("compo")
        for f in arrays:
            x, y = getattr(b, f), getattr(h, f)
            assert x.shape == y.shape
            assert np.array_equal(np.isinf(x), np.isinf(y)), f
            fin = np.isfinite(y)
            np.testing.assert_allclose(x[fin], y[fin], rtol=0, atol=1e-5)
    ref = r_hmmfile.read_hmm(io.StringIO(text))
    for r, b in zip(ref, back):
        assert same_fields(p_hmmfile.HMMProfile(**vars(r)), b)


MULTIHOST_COPIES = ["partition_sizes", "process_slice", "wait_for_shards",
                    "_write_failure_report", "supervise_shards",
                    "merge_product_shards"]


@pytest.mark.parametrize("name", MULTIHOST_COPIES)
def test_multihost_copy(name, tmp_path):
    """The multi-process scan's host functions are the reference's, line
    for line (their relative imports resolve inside the port), and give
    the same results on the same inputs."""
    got, want = getattr(p_multihost, name), getattr(r_multihost, name)
    assert inspect.getsource(got) == inspect.getsource(want)
    if name == "partition_sizes":
        for n, k in ((0, 3), (10, 3), (7, 8), (1000, 7)):
            assert got(n, k) == want(n, k)
    elif name == "process_slice":
        for n, k in ((11, 3), (2, 4), (200, 2)):
            assert [got(n, k, i) for i in range(k)] == \
                [want(n, k, i) for i in range(k)]
    elif name == "wait_for_shards":
        (tmp_path / "shard.1.done").write_text("")
        assert got(str(tmp_path), 3, 0.05) == want(str(tmp_path), 3, 0.05)
    elif name == "_write_failure_report":
        for fn in (got, want):
            path = fn(str(tmp_path), [2], 3)
            rep = json.loads(Path(path).read_text())
            assert rep["failed_shards"] == [2] and rep["num_processes"] == 3
    elif name == "supervise_shards":
        class Done:
            def __init__(self, pid):
                (tmp_path / f"shard.{pid}.done").write_text("")

            def poll(self):
                return 0

        assert got(str(tmp_path), 2, Done, poll_s=0) == \
            want(str(tmp_path), 2, Done, poll_s=0)
    else:
        row = "{s}\t0\t0\t10\t0\t0\t10\t{p}\tdna\t5.0\t1\t,B,,;,E,,\n"
        for i, prof in enumerate(("PB", "PA")):
            (tmp_path / f"s{i}").mkdir()
            (tmp_path / f"s{i}" / "products.tsv").write_text(
                p_product.HEADER + row.format(s=i, p=prof))
        shards = [str(tmp_path / "s0"), str(tmp_path / "s1")]
        a = Path(got(str(tmp_path / "a"), shards, ["PA", "PB"])).read_text()
        b = Path(want(str(tmp_path / "b"), shards, ["PA", "PB"])).read_text()
        assert a == b and a.splitlines()[1].split("\t")[7] == "PA"


@pytest.mark.parametrize("num_profiles,K,B,L", [(2, 24, 2, 48), (3, 9, 4, 7)])
def test_graft_tiny_workload_copy(num_profiles, K, B, L):
    """graft_entry's example workload is the reference's __graft_entry__
    `_tiny_workload`, array for array."""
    import __graft_entry__ as r_graft

    import deciphon_tpu_torch.graft_entry as p_graft

    want = r_graft._tiny_workload(num_profiles, K, B, L)
    got = p_graft._tiny_workload(num_profiles, K, B, L)
    assert same_fields(got[0], want[0])
    assert all(same(a, b) for a, b in zip(got[1:], want[1:]))
