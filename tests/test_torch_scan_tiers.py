"""The port's phase-1 tiers end to end, and the pipeline features that come
with the chain tier.

With the chain admission cap and the rung floor shrunk to 4 blocks (as
tests/test_chain.py does for the reference), the planted reads' windows
ride the over-cap tiers: the mixed-profile gang (default) or carry
segments (DECIPHON_CHAIN_SEG=1); DECIPHON_NO_CHAIN=1 sends everything to
the classic buckets.  Two of the three profiles (K = 40 and 9) form a
packed class, so their whole-read windows ride the packed tiers beside
those (B7, or B6 under DECIPHON_NO_CHAIN=1).  Each tier's products.tsv must be byte-identical to
the reference's lax.scan engine (engine="jax").  Inputs are numpy-seeded;
products compare byte for byte.
"""

import json
import os

import numpy as np
import pytest
import torch

from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan import pipeline as ref_pipeline
from deciphon_tpu.scan.sequence import Sequence
from deciphon_tpu_torch.convert import (costs_from_arrays,
                                        frame_profile_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as ts
from deciphon_tpu_torch.scan.scheduler import PairItem
from deciphon_tpu_torch.scan.window import Window
from deciphon_tpu_torch.workload import planted_read, random_bases

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def planted():
    """tests/test_torch_scan.py's planted fixture plus one 150-nt read,
    whose 4-block windows pin a tiny chain cap.  Returns the reference's
    objects and the port's, carried across as arrays."""
    ref_profiles = [sample_profile(140, 40), sample_profile(250, 150),
                    sample_profile(109, 9)]
    profiles = [frame_profile_from_arrays(**vars(p)) for p in ref_profiles]
    rng = np.random.default_rng(7)
    reads = [planted_read(rng, profiles[0], 300),
             planted_read(rng, profiles[1], 500, noise=0.01),
             random_bases(rng, 250),
             planted_read(rng, profiles[2], 480),
             random_bases(rng, 150)]
    ref_seqs = [Sequence.make(i, f"r{i}", r) for i, r in enumerate(reads)]
    seqs = [sequence_from_arrays(**vars(s)) for s in ref_seqs]
    return (ref_profiles, ref_seqs), (profiles, seqs)


@pytest.fixture(scope="module")
def jax_products(planted, tmp_path_factory):
    profiles, seqs = planted[0]
    ref = ref_pipeline.Scanner(profiles,
                               ref_pipeline.ScanConfig(engine="jax"))
    with open(ref.run(seqs, str(tmp_path_factory.mktemp("jax"))), "rb") as fp:
        return fp.read()


@pytest.fixture
def counted(monkeypatch):
    """Calls per phase-1 wrapper, through the scheduler's module alias."""
    calls = {}
    for name in ("scores_pairs", "scores_pairs_chained",
                 "scores_pairs_mixed", "scores_pairs_chained_carry",
                 "scores_pairs_packed", "scores_pairs_packed_chained"):
        fn = getattr(vk, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(vk, name, wrapped)
    return calls


def shrink_caps(monkeypatch):
    monkeypatch.setattr(ts.PairScorer, "CHAIN_MAX_BLK", 4)
    monkeypatch.setattr(ts.PairScorer, "NLB_FLOOR", 4)


def scan(profiles, seqs, out, **kw) -> tuple[bytes, tp.Scanner]:
    sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu", **kw))
    with open(sc.run(seqs, str(out)), "rb") as fp:
        return fp.read(), sc


@pytest.mark.parametrize("tier", ["chain+gang", "chain+seg", "classic"])
def test_tier_products_byte_identical_to_jax(planted, jax_products,
                                             tmp_path, monkeypatch, counted,
                                             tier):
    profiles, seqs = planted[1]
    shrink_caps(monkeypatch)
    if tier == "chain+seg":
        monkeypatch.setenv("DECIPHON_CHAIN_SEG", "1")
    if tier == "classic":
        monkeypatch.setenv("DECIPHON_NO_CHAIN", "1")
    got, sc = scan(profiles, seqs, tmp_path / "torch")
    assert sc.metrics.survivors > 0 and sc.metrics.products > 0
    assert got == jax_products
    # normal windows ride the segment chunks' spare slots under seg
    want = {"chain+gang": {"scores_pairs_chained", "scores_pairs_mixed",
                           "scores_pairs_packed_chained"},
            "chain+seg": {"scores_pairs_chained_carry",
                          "scores_pairs_packed_chained"},
            "classic": {"scores_pairs", "scores_pairs_packed"}}[tier]
    assert want <= set(counted)
    assert not {"chain+gang": {"scores_pairs_chained_carry"},
                "chain+seg": {"scores_pairs_mixed"},
                "classic": set(counted) - want}[tier] & set(counted)


def test_default_tier_is_chain(planted, jax_products, tmp_path, counted):
    """Without switches and at the reference's caps every window of the
    planted scan is chainable: the chain tiers alone, unpacked and packed,
    score them."""
    profiles, seqs = planted[1]
    got, _ = scan(profiles, seqs, tmp_path / "torch")
    assert got == jax_products
    assert set(counted) == {"scores_pairs_chained",
                            "scores_pairs_packed_chained"}


def test_leftover_chunk_at_narrow_width_launches_once(monkeypatch):
    """With w_c == 8 the narrow width w_n is also 8; every leftover chain
    chunk is launched once (the reference loops over (w_c, w_n) and
    launches each twice)."""
    from deciphon_tpu.ops.costs import build_costs

    costs = [costs_from_arrays(**vars(build_costs(sample_profile(s, k))))
             for s, k in [(1, 9), (2, 20)]]
    rng = np.random.default_rng(4)
    seqs = [sequence_from_arrays(
        **vars(Sequence.make(i, f"s{i}", random_bases(rng, 60 + 41 * i))))
        for i in range(5)]
    codes = ts.DeviceSeqCodes(seqs, "cpu")
    items = [PairItem(p_idx=p, s_idx=i, win=Window(0, 0, s.size),
                      multi_hits=True, hmmer3_compat=False, seq=s,
                      gstart=codes.gstart(i, 0))
             for p in range(2) for i, s in enumerate(seqs)]
    scorer = ts.PairScorer(costs, "cpu", w=8)
    scorer.set_device_codes(codes)
    launched = []
    real = scorer._invoke_scores_chained

    def spy(pidx, sblk, wlen, *rest):
        launched.append(int((wlen > 0).sum()))
        return real(pidx, sblk, wlen, *rest)

    monkeypatch.setattr(scorer, "_invoke_scores_chained", spy)
    inflight = scorer.dispatch(items)
    assert scorer._chain_pin[2] == 8  # w_c == w_n == 8
    assert sum(launched) == len(items)
    got = scorer.collect(inflight)
    assert set(got) == {id(it) for it in items}
    scorer.set_device_codes(codes)
    monkeypatch.setenv("DECIPHON_NO_CHAIN", "1")
    assert scorer.score(items) == got


def test_checkpoint_resume_identical(planted, tmp_path):
    """A scan stopped by should_stop after a few waves leaves a journal;
    a fresh scanner resumes from it to the same products, scoring fewer
    windows than a full scan."""
    profiles, seqs = planted[1]
    kw = dict(max_pairs=1, spec_depth=1)
    full, full_sc = scan(profiles, seqs, tmp_path / "full", **kw)
    d = tmp_path / "crash"
    sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu", **kw))
    asked = {"n": 0}
    waves = full_sc.metrics.pairs_batches
    assert waves >= 2

    def stop():  # asked before every wave: stop before the last collect
        asked["n"] += 1
        return asked["n"] > waves

    with pytest.raises(tp.Scanner.Interrupted):
        sc.run(seqs, str(d), checkpoint=True, should_stop=stop)
    assert sc._dev_codes is None
    assert 0 < sc.progress < 100
    journal = d / ".scan_checkpoint.jsonl"
    kinds = [json.loads(r)["kind"] for r in journal.read_text().split("\n")
             if r]
    assert "pair_done" in kinds
    sc2 = tp.Scanner(profiles, tp.ScanConfig(device="cpu", **kw))
    with open(sc2.run(seqs, str(d), checkpoint=True), "rb") as fp:
        again = fp.read()
    assert again == full
    assert sc2.metrics.windows_scored < full_sc.metrics.windows_scored
    assert sc2.progress == 100
    assert not journal.exists()


def test_should_stop_raises_interrupted(planted, tmp_path):
    profiles, seqs = planted[1]
    sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu"))
    with pytest.raises(tp.Scanner.Interrupted):
        sc.run(seqs, str(tmp_path / "p"), should_stop=lambda: True)
    assert sc._dev_codes is None
    assert sc.progress == 0


def test_warmup_and_release(planted, jax_products, tmp_path):
    profiles, seqs = planted[1]
    sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu"))
    secs = sc.warmup(read_lengths=[300], reads_per_length=2)
    assert isinstance(secs, float) and secs > 0
    with open(sc.run(seqs, str(tmp_path / "a")), "rb") as fp:
        assert fp.read() == jax_products
    assert sc.progress == 100
    sc.release()
    assert sc.scorer is None
    with open(sc.run(seqs, str(tmp_path / "b")), "rb") as fp:
        assert fp.read() == jax_products
    assert os.path.isdir(tmp_path / "b" / "hmmer")
