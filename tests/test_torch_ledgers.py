"""The bucket ledgers (DECIPHON_SYNC_DEBUG, DECIPHON_FILL_DEBUG) of every
phase-1 tier against the reference's, on the CPU.

The reference's BucketedPairScorer (Pallas interpret mode) and the port's
scan tests/test_torch_scan_tiers.py's planted reads under
DECIPHON_SYNC_DEBUG=1 DECIPHON_FILL_DEBUG=1, on three routes:

  * "gang": the chain caps shrunk to 4 blocks (as tests/test_chain.py does
    for the reference): chain (B3), gang (B5) and packed chain (B7);
  * "seg": the same under DECIPHON_CHAIN_SEG=1: carry segments (B8);
  * "classic": the chain tier off (`PairScorer.CHAIN = False`, which the
    reference's packed tier reads; its packed tier ignores
    DECIPHON_NO_CHAIN) and the widest plain bucket lowered to Kp 128, so
    that the K = 150 profile's bucket rides the large-K tier: classic
    buckets (B1), `_hbm` buckets (B4) and packed rungs (B6).

Each tier's ledger names, true and padded cells and counts must be the
reference's, every name must have a wall, the true cells must be those
of the windows phase 1 dispatched, and with the switch off the ledger is
the same (the cells are counted at every launch; the switch adds the
wait and its wall), as are the products, launches and table uploads.
The port's ledger also holds its B2 launches under `path_` names, which
the reference's has not.

Two departures of the reference are stated, not copied:
  * with a chain width w_c of 8 the narrow width w_n is 8 too, and the
    reference's `for wb in (w_c, w_n)` dispatches every leftover chain
    and packed-chain chunk twice (deciphon_tpu/scan/scheduler.py:765-773
    and its packed twin), so its ledger holds each such name with twice
    the cells and count, and prints its FILL line twice; the port
    launches each chunk once.  Every chain pin of these scans has w_c 8,
    so the rule applies to every leftover chunk here; carry chunks
    (bkt_chainseg) are dispatched once by both.
  * the gang's kernel: the reference runs its VMEM-table kernel (its
    name bkt_gangv) while its table stack fits MIXED_VMEM_TABLE_BUDGET
    (48 MB), the port runs B5 (bkt_gangv) for every resident stack.
    For a resident stack past 48 MB the names differ (bkt_gang against
    bkt_gangv); these tables are far below it, so the names agree.
"""

import collections
import contextlib
import io

import numpy as np
import pytest
import torch

from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan import pipeline as ref_pipeline
from deciphon_tpu.scan import scheduler as ref_sched
from deciphon_tpu.scan.sequence import Sequence
from deciphon_tpu_torch.convert import (frame_profile_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as ts
from deciphon_tpu_torch.workload import planted_read, random_bases

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

SWITCHES = {"DECIPHON_SYNC_DEBUG": "1", "DECIPHON_FILL_DEBUG": "1"}

# tier -> (route, name test)
TIERS = {
    "chain": ("gang", lambda n: n.startswith("bkt_chain_")),
    "gang": ("gang", lambda n: n.startswith("bkt_gangv_")),
    "pchain": ("gang", lambda n: n.startswith("bkt_pchain_")),
    "carry": ("seg", lambda n: n.startswith("bkt_chainseg_")),
    "classic": ("classic", lambda n: n.startswith("bkt_kp")
                and not n.endswith("_hbm")),
    "hbm": ("classic", lambda n: n.startswith("bkt_kp") and n.endswith("_hbm")),
    "packed": ("classic", lambda n: n.startswith("bkt_packed_")),
}
# names the reference dispatches twice (leftover chunks at w_c == w_n == 8)
TWICE = ("bkt_chain_", "bkt_pchain_")


@pytest.fixture(scope="module")
def planted():
    """tests/test_torch_scan_tiers.py's planted fixture: three profiles (K
    40 and 9 pack side by side, K 150 has a plain bucket), five reads, two
    planted and one of 150 nt, whose 4-block windows pin a tiny chain cap
    when the caps are shrunk."""
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


@contextlib.contextmanager
def route(name: str, env: dict):
    """The route's class attributes and switches on both packages."""
    with pytest.MonkeyPatch.context() as mp:
        if name in ("gang", "seg"):
            for cls in (ts.PairScorer, ref_sched.PairScorer):
                mp.setattr(cls, "CHAIN_MAX_BLK", 4)
                mp.setattr(cls, "NLB_FLOOR", 4)
        if name == "seg":
            mp.setenv("DECIPHON_CHAIN_SEG", "1")
        if name == "classic":
            for cls in (ts.PairScorer, ref_sched.PairScorer):
                mp.setattr(cls, "CHAIN", False)
            mp.setattr(ts.BucketedPairScorer, "MAX_KP", 128)
            mp.setattr(ref_sched.BucketedPairScorer, "MAX_PALLAS_KP", 128)
        for k, v in env.items():
            mp.setenv(k, v)
        yield


def fill_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("FILL ")]


def ref_scan(planted, name, out) -> dict:
    profiles, seqs = planted[0]
    with route(name, SWITCHES):
        sc = ref_pipeline.Scanner(
            profiles, ref_pipeline.ScanConfig(engine="pallas-interpret"),
            scorer=lambda c: ref_sched.BucketedPairScorer(c, interpret=True))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            path = sc.run(seqs, str(out))
    with open(path, "rb") as fp:
        products = fp.read()
    m = sc.metrics
    return dict(products=products, cells=dict(m.bucket_cells),
                walls=dict(m.walls), fill=fill_lines(buf.getvalue()))


def port_scan(planted, name, out, env: dict, budget=None) -> dict:
    """The port's scan on the CPU, with its launches, its table uploads,
    the cells of the windows its phase 1 dispatched (all, and those still
    valid at collect) and the chain pins' widths."""
    profiles, seqs = planted[1]
    ks = [p.core_size for p in profiles]
    dispatched, widths, rows = [], set(), {}

    def packed_rows(scorer, items):
        """The packed tiers' rows (one a pack and window) with the K of
        every profile of the row's pack: the reference's true cells of a
        row count them all (`_pack_ksum`), present in the row or not."""
        for it in items:
            pack = it.p_idx // scorer.nseg
            ksum = sum(scorer.inner._Ks[pack * scorer.nseg:
                                        (pack + 1) * scorer.nseg])
            rows[(id(scorer), pack, it.s_idx, it.win.start, it.win.stop)] = \
                it.win.length * 5 * int(ksum)
            rows.setdefault("items", 0)
            rows["items"] += it.win.length * 5 * int(scorer.inner._Ks[it.p_idx])

    chained = ts.PackedPairScorer._dispatch_packed_chained
    rungs = ts.PackedPairScorer._dispatch_packed

    def spy_chained(self, items):
        leftover, entries = chained(self, items)
        left = {id(it) for it in leftover}
        packed_rows(self, [it for it in items if id(it) not in left])
        return leftover, entries

    def spy_rungs(self, items):
        packed_rows(self, items)
        return rungs(self, items)

    with route(name, env), pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts.PackedPairScorer, "_dispatch_packed_chained",
                   spy_chained)
        mp.setattr(ts.PackedPairScorer, "_dispatch_packed", spy_rungs)
        sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu"), scorer=(
            lambda c: ts.BucketedPairScorer(c, "cpu", hbm_budget=budget)))
        real = sc.scorer.dispatch_all
        pinned = sc.scorer.scorers + [s.inner for s in sc.scorer.scorers
                                      if hasattr(s, "inner")]

        def spy(items):
            dispatched.extend(items)
            pending = real(items)
            widths.update(s._chain_pin[2] for s in pinned
                          if s._chain_pin is not None)
            return pending

        sc.scorer.dispatch_all = spy
        vk.reset_launches()
        ts.reset_uploads()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            path = sc.run(seqs, str(out))
        launches, uploads = dict(vk.LAUNCHES), dict(ts.UPLOADS)
    with open(path, "rb") as fp:
        products = fp.read()
    m = sc.metrics
    return dict(
        products=products, ledger=dict(m.bucket_cells),
        cells={n: c for n, c in m.bucket_cells.items()
               if not n.startswith("path_")},
        path_cells={n: c for n, c in m.bucket_cells.items()
                    if n.startswith("path_")},
        walls=dict(m.walls),
        fill=fill_lines(buf.getvalue()), launches=launches, uploads=uploads,
        metrics_cells=m.cells,
        dispatched=sum(it.win.length * 5 * ks[it.p_idx] for it in dispatched),
        valid=sum(it.win.length * 5 * ks[it.p_idx] for it in dispatched
                  if it.valid),
        packed_items=rows.pop("items", 0), packed_rows=sum(rows.values()),
        widths=widths)


_SCANS: dict = {}


@pytest.fixture
def scans(planted, tmp_path_factory):
    """route -> (reference, port with the switches, port without), each
    scanned once a module."""
    def get(name):
        if name not in _SCANS:
            tmp = tmp_path_factory.mktemp(name)
            _SCANS[name] = (ref_scan(planted, name, tmp / "ref"),
                            port_scan(planted, name, tmp / "on", SWITCHES),
                            port_scan(planted, name, tmp / "off", {}))
        return _SCANS[name]
    return get


def expected_ref(port_cells: dict) -> dict:
    """The port's ledger as the reference records it: the names it
    dispatches twice with twice the cells and count."""
    return {n: tuple(2 * v for v in c) if n.startswith(TWICE) else c
            for n, c in port_cells.items()}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tier_ledger_matches_reference(scans, tier):
    name, picks = TIERS[tier]
    ref, on, _ = scans(name)
    assert on["widths"] <= {8}, "the double-dispatch rule needs w_c == 8"
    got = {n: c for n, c in on["cells"].items() if picks(n)}
    want = {n: c for n, c in ref["cells"].items() if picks(n)}
    assert got, f"no {tier} launch on the {name} route"
    assert expected_ref(got) == want
    assert set(got) <= set(on["walls"])
    assert on["products"] == ref["products"]


@pytest.mark.parametrize("name", ["gang", "seg", "classic"])
def test_route_ledger_whole(scans, name):
    """Every ledger name of the route is the reference's; the true cells
    are those of the windows phase 1 dispatched (ScanMetrics.cells counts
    the ones still valid at collect), a packed row's counted for every
    profile of its pack, as the reference counts them (here the K = 9
    profile's windows of reads 1 and 3 are not whole, so the K = 40
    profile's whole-read rows of those reads hold one profile of two);
    FILL lines are the reference's; with the switches off: the same
    ledger, B2's entries included, no bkt_ wall, the same products,
    launches and uploads."""
    ref, on, off = scans(name)
    assert expected_ref(on["cells"]) == ref["cells"]
    assert all(n.startswith("bkt_") for n in on["cells"])
    assert set(on["ledger"]) == set(on["cells"]) | set(on["path_cells"])
    assert on["path_cells"]
    assert all(0 < t <= p for t, p, _ in on["path_cells"].values())
    assert set(on["cells"]) <= set(on["walls"])
    assert on["packed_rows"] > on["packed_items"] > 0
    assert sum(t for t, _, _ in on["cells"].values()) == \
        on["dispatched"] - on["packed_items"] + on["packed_rows"]
    assert on["valid"] == on["metrics_cells"]
    want_fill = collections.Counter(
        ln for ln in on["fill"]
        for _ in range(2 if ln.startswith(("FILL bkt_chain_",)) else 1))
    assert collections.Counter(ref["fill"]) == want_fill
    n_chain = sum(c[2] for n, c in on["cells"].items()
                  if n.startswith(("bkt_chain_", "bkt_chainseg_")))
    assert len(on["fill"]) == n_chain
    assert not any(k.startswith("bkt_") for k in off["walls"])
    assert off["cells"] == on["cells"]
    assert off["path_cells"] == on["path_cells"]
    assert off["products"] == on["products"] == ref["products"]
    assert off["launches"] == on["launches"]
    assert off["uploads"] == on["uploads"]


@pytest.mark.parametrize("name", ["gang", "seg"])
def test_streamed_ledger_moves_no_upload(planted, tmp_path, name):
    """With every table streamed (a budget of 1 byte), waiting for each
    launch moves no placement: the same table uploads, launches, products
    and ledger with the switches on and off; the streamed gang's entries
    are named bkt_gang (B4m), as the reference names its streamed gang."""
    on = port_scan(planted, name, tmp_path / "on", SWITCHES, budget=1)
    off = port_scan(planted, name, tmp_path / "off", {}, budget=1)
    assert on["uploads"]["uploads"] > 0
    assert (on["uploads"], on["launches"], on["products"]) == \
        (off["uploads"], off["launches"], off["products"])
    assert on["cells"] and off["cells"] == on["cells"]
    gang = [n for n in on["cells"] if n.startswith("bkt_gang")]
    assert all(n.startswith("bkt_gang_") for n in gang)
    assert bool(gang) == (name == "gang")
