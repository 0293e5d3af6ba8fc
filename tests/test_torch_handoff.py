"""The scan's hand-off between the host and the card: on the card a
launch's metadata goes up staged (`scheduler._tensors` -> `logging.stage`:
one pinned buffer, one `non_blocking` copy on the launching stream) and a
path entry's steps come down into pinned memory right after its walk, read
once that entry's own event has passed (`traceback.stage_steps`,
`fetch_steps`, `PathSteps`); the host never drains a stream to hand work
over.  On the CPU nothing is staged and the route is the one it was.

CPU tests on a planted scan through the plain versions, and card tests,
skipped without a card.  They import nothing but the port; on the card's
machine run them as

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_handoff.py
"""

import numpy as np
import pytest
import torch

from deciphon_tpu_torch import logging as dlog
from deciphon_tpu_torch.ops import traceback as tb
from deciphon_tpu_torch.ops.costs import build_costs
from deciphon_tpu_torch.profile import sample_profile
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as ts
from deciphon_tpu_torch.scan.sequence import Sequence
from deciphon_tpu_torch.scan.window import Window
from deciphon_tpu_torch.workload import planted_read, random_bases

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

# GPU cycles of a `torch.cuda._sleep` that outlasts what a test does on
# the host meanwhile (about a second on an H100).
SLEEP_CYCLES = 2_000_000_000


@pytest.fixture(scope="module")
def planted():
    """Three profiles (K 40 and 9 pack side by side, K 150 has a plain
    bucket) and five reads, three of them planted."""
    profiles = [sample_profile(140, 40), sample_profile(250, 150),
                sample_profile(109, 9)]
    rng = np.random.default_rng(7)
    reads = [planted_read(rng, profiles[0], 300),
             planted_read(rng, profiles[1], 500, noise=0.01),
             random_bases(rng, 250),
             planted_read(rng, profiles[2], 480),
             random_bases(rng, 150)]
    return profiles, [Sequence.make(i, f"r{i}", r)
                      for i, r in enumerate(reads)]


def scan(planted, out, device="cpu", scanner=None):
    """(scanner, products) of one run; a given scanner runs again."""
    profiles, seqs = planted
    sc = scanner or tp.Scanner(profiles, tp.ScanConfig(device=device))
    with open(sc.run(seqs, str(out))) as fp:
        return sc, fp.read()


def path_case(device, lengths=(700, 90, 300, 95, 640, 310)):
    """A PairScorer of two profiles on `device` and survivors of theirs
    whose windows fall on three rungs of B2's buckets, the first
    survivor on the longest."""
    profiles = [sample_profile(21, 40), sample_profile(22, 60)]
    scorer = ts.PairScorer([build_costs(p) for p in profiles], device)
    rng = np.random.default_rng(5)
    seqs = [Sequence.make(i, f"s{i}", random_bases(rng, n))
            for i, n in enumerate(lengths)]
    codes = ts.DeviceSeqCodes(seqs, device)
    scorer.set_device_codes(codes)
    items = [ts.PairItem(p_idx=i % 2, s_idx=i, win=Window(0, 0, s.size),
                         multi_hits=True, hmmer3_compat=False, seq=s,
                         gstart=codes.gstart(i, 0))
             for i, s in enumerate(seqs)]
    return scorer, items


class FakeEvent:
    """Stands for a CUDA event on the CPU: counts the host's waits."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def equal_paths(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k][0], b[k][0]) and np.array_equal(a[k][1], b[k][1])
        for k in a)


def test_cpu_route_stages_nothing(planted, tmp_path, monkeypatch):
    """On the CPU `_tensors` stages nothing (no `staged`, no
    `staged_bytes`), no step entry is staged, and `syncs` counts what it
    always counted: every array of a plain upload and every read."""
    def never(*a, **k):
        raise AssertionError("staged on the CPU")

    uploads, reads = [], []

    def spy_to_device(device, *arrays):
        uploads.append(len(arrays))
        return dlog.to_device(device, *arrays)

    def spy_to_host(t):
        reads.append(t.numel())
        return dlog.to_host(t)

    monkeypatch.setattr(ts, "stage", never)
    monkeypatch.setattr(tb, "read_staged", never)
    monkeypatch.setattr(ts, "to_device", spy_to_device)
    monkeypatch.setattr(ts, "to_host", spy_to_host)
    monkeypatch.setattr(tb, "to_host", spy_to_host)
    monkeypatch.setattr(tb, "to_device", spy_to_device)
    sc, _ = scan(planted, tmp_path / "out")
    counts = sc.metrics.counts
    assert "staged" not in counts and "staged_bytes" not in counts
    assert uploads and reads
    assert counts["syncs"] == sum(uploads) + len(reads)
    assert "wait" not in sc.metrics.walls


def test_lazy_path_steps_equal_one_transfer():
    """`PathSteps` over staged entries and a dict collected early gives
    the {id(item): (sids, sizes)} that one transfer of every entry gave,
    waits on no entry before one of its survivors is asked for, and on
    each entry once; over entries that are not staged (the CPU) it holds
    everything at once."""
    scorer, items = path_case("cpu")
    entries = [launch() for *_, launch in scorer.path_launches(items)]
    assert len(entries) == 3 and all(e[9] is None for e in entries)
    early: dict = {}
    tb.assemble_path_entries(entries[:1], tb.fetch_steps(entries[:1]),
                             early)
    rest = entries[1:]
    want = dict(early)
    tb.assemble_path_entries(rest, tb.fetch_steps(rest), want)
    assert len(want) == len(items)

    now = tb.PathSteps([*rest, early])
    assert equal_paths(dict(now), want)

    events = [FakeEvent() for _ in rest]
    staged = [(*e[:9], (tuple(a.clone() for a in e[1:5]), ev))
              for e, ev in zip(rest, events)]
    lazy = tb.PathSteps([early, *staged])
    assert lazy.keys() == early.keys()
    assert all(ev.waits == 0 for ev in events)
    for it in items:  # the decode's order
        got = lazy[id(it)]
        assert np.array_equal(got[0], want[id(it)][0])
        assert np.array_equal(got[1], want[id(it)][1])
        owner = [j for j, e in enumerate(staged) if it in e[0]]
        assert owner == [] or events[owner[0]].waits == 1
    assert [ev.waits for ev in events] == [1] * len(events)
    assert equal_paths(dict(lazy), want)


@pytest.mark.parametrize("bound", [None, 1])
def test_staged_step_route_on_the_cpu(planted, tmp_path, monkeypatch,
                                      bound):
    """The card's route of the step read, rehearsed on the CPU with every
    entry staged (host copies and a stand-in event): the products are the
    plain scan's, every staged entry is waited on once (a `wait` span,
    which the CPU route never has) and no one-transfer read is left but
    the early collects of a bound of one byte (every launch but the last,
    each after its own event)."""
    _, want = scan(planted, tmp_path / "plain")
    events = []

    def stage_steps(*steps):
        events.append(FakeEvent())
        return tuple(a.clone() for a in steps), events[-1]

    def bounded(costs):
        b = ts.BucketedPairScorer(costs, "cpu")
        b.path_inflight_bytes = bound
        return b

    monkeypatch.setattr(ts, "stage_steps", stage_steps)
    profiles, seqs = planted
    sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu"),
                    scorer=None if bound is None else bounded)
    with open(sc.run(seqs, str(tmp_path / "staged"))) as fp:
        got = fp.read()
    assert got == want
    m = sc.metrics
    assert events and m.survivors > 0
    assert [ev.waits for ev in events] == [1] * len(events)
    assert "wait" in m.walls
    assert ("phase2_collect" in m.walls) == (bound is not None)


def test_path_launches_follow_first_survivor():
    """A scorer's path launches come in the order of their first survivor
    (each yields it), and a wave's entries across sub-scorers too."""
    scorer, items = path_case("cpu")
    plan = list(scorer.path_launches(items))
    rank = {id(it): i for i, it in enumerate(items)}
    firsts = [rank[id(first)] for first, _, _ in plan]
    assert firsts == sorted(firsts) and firsts[0] == 0
    for first, _, launch in plan:
        entry = launch()
        assert first in entry[0]
        assert rank[id(first)] == min(rank[id(it)] for it in entry[0])

    profiles = [sample_profile(21, 40), sample_profile(23, 300),
                sample_profile(22, 60), sample_profile(24, 200)]
    b = ts.BucketedPairScorer([build_costs(p) for p in profiles], "cpu")
    assert len(b.scorers) > 1
    rng = np.random.default_rng(9)
    seqs = [Sequence.make(i, f"s{i}", random_bases(rng, 120 + 97 * i))
            for i in range(8)]
    codes = ts.DeviceSeqCodes(seqs, "cpu")
    b.set_device_codes(codes)
    wave = [ts.PairItem(p_idx=(3 * i) % 4, s_idx=i,
                        win=Window(0, 0, s.size), multi_hits=True,
                        hmmer3_compat=False, seq=s,
                        gstart=codes.gstart(i, 0))
            for i, s in enumerate(seqs)]
    rank = {id(it): i for i, it in enumerate(wave)}
    entries = b.paths_dispatch(wave)
    assert [it.p_idx for it in wave] == [(3 * i) % 4 for i in range(8)]
    firsts = [min(rank[id(it)] for it in e[0]) for e in entries]
    assert len(firsts) > 1 and firsts == sorted(firsts)
    assert sorted(rank[id(it)] for e in entries for it in e[0]) == \
        list(range(len(wave)))


def test_stage_counts_and_views():
    """`stage`'s typed views of its one buffer keep each array's dtype,
    shape and bytes, an empty array's too (here on the CPU, with the host
    buffer unpinned), and its counts are `staged`, `staged_bytes` and
    `h2d_bytes`, never `syncs`."""
    arrays = [np.arange(7, dtype=np.int32).reshape(7, 1),
              np.linspace(0, 1, 13, dtype=np.float32),
              np.zeros((0, 3), np.int32), np.array([3, 1], np.int64)]
    m = dlog.ScanMetrics()
    real_empty = torch.empty

    def empty(*a, pin_memory=False, **k):  # no pinned memory without a card
        return real_empty(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "empty", empty)
        with m.running():
            out = dlog.stage("cpu", *arrays)
    for t, a in zip(out, arrays):
        assert t.dtype == torch.from_numpy(a).dtype and t.shape == a.shape
        assert np.array_equal(t.numpy(), a)
    nbytes = sum(a.nbytes for a in arrays)
    assert m.counts == {"staged": 1, "staged_bytes": nbytes,
                        "h2d_bytes": nbytes}


def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")


@pytest.mark.cuda
def test_tensors_do_not_drain():
    """On the card `_tensors` returns while a sleep queued before it still
    runs, and its tensors equal the arrays even when these are overwritten
    right after the call; under a shard's stream the copy runs there, not
    behind the default stream's work."""
    cuda()
    arrays = [np.arange(4096, dtype=np.int32).reshape(64, 64),
              np.linspace(-1, 1, 999, dtype=np.float32),
              np.array([5, 7], np.int64)]
    want = [a.copy() for a in arrays]
    m = dlog.ScanMetrics()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    slept = torch.cuda.Event()
    slept.record()
    with m.running():
        out = ts._tensors("cuda", *arrays)
    assert not slept.query()
    for a in arrays:
        a[...] = -1
    torch.cuda.synchronize()
    assert all(np.array_equal(t.cpu().numpy(), w) for t, w in zip(out, want))
    assert m.counts["staged"] == 1
    assert m.counts["staged_bytes"] == sum(w.nbytes for w in want)
    assert m.counts.get("syncs", 0) == 0

    side = torch.cuda.Stream()
    torch.cuda._sleep(SLEEP_CYCLES)  # on the default stream
    slept.record()
    with torch.cuda.stream(side):
        out = ts._tensors("cuda", *want)
        got = [t.cpu().numpy() for t in out]  # waits for `side` alone
    assert not slept.query()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_entry_steps_readable_after_their_own_event():
    """A path entry's steps are read as soon as its own event has passed,
    while a sleep queued after it still runs; they equal the walk's
    arrays, and the read is one of `syncs` and no drain."""
    cuda()
    scorer, items = path_case("cuda")
    entries = [launch() for *_, launch in scorer.path_launches(items)]
    torch.cuda._sleep(SLEEP_CYCLES)
    slept = torch.cuda.Event()
    slept.record()
    m = dlog.ScanMetrics()
    with m.running():
        fetched = tb.fetch_steps(entries[:1])
    assert entries[0][9][1].query()
    assert not slept.query()
    assert m.counts["syncs"] == 1 and "wait" in m.walls
    torch.cuda.synchronize()
    want = [a.cpu().numpy() for a in entries[0][1:5]]
    assert all(np.array_equal(g, w) for g, w in zip(fetched, want))
    out: dict = {}
    tb.assemble_path_entries(entries, tb.fetch_steps(entries), out)
    cpu_scorer, cpu_items = path_case("cpu")
    cpu_entries = [launch() for *_, launch
                   in cpu_scorer.path_launches(cpu_items)]
    cpu_out: dict = {}
    tb.assemble_path_entries(cpu_entries, tb.fetch_steps(cpu_entries),
                             cpu_out)
    assert equal_paths({i: out[id(it)] for i, it in enumerate(items)},
                       {i: cpu_out[id(it)]
                        for i, it in enumerate(cpu_items)})


@pytest.mark.cuda
def test_card_scan_hands_off_on_events(planted, tmp_path, monkeypatch):
    """A card scan of the planted fixture writes the CPU route's products
    byte for byte, stages every launch's metadata, launches what the
    serial hand-off (DECIPHON_SYNC_DEBUG: a wait after every phase-1
    launch) launches and what the bucket ledger plans (one phase-1 launch
    a bkt_ entry, one B2 and one walk a path_ entry, the plan of the CPU
    route), and waits on the host a small constant a wave."""
    cuda()
    cpu, want = scan(planted, tmp_path / "cpu")
    sc, _ = scan(planted, tmp_path / "warm", device="cuda")
    sc, got = scan(planted, tmp_path / "card", scanner=sc)
    assert got == want
    m = sc.metrics
    counts = m.counts
    launches = counts["launches"]
    cells = m.bucket_cells
    assert cells == cpu.metrics.bucket_cells
    bkt = sum(n for k, (_, _, n) in cells.items() if k.startswith("bkt_"))
    path = sum(n for k, (_, _, n) in cells.items() if k.startswith("path_"))
    assert launches["path"] == launches["walk"] == path > 0
    assert sum(v for k, v in launches.items()
               if k not in ("path", "walk")) == bkt > 0
    assert counts["staged"] >= bkt + 2 * path
    assert counts["staged_bytes"] > 0
    # per wave: the phase-1 read and a wait a path entry; once: the
    # reads' upload (no walk of this fixture overflows: no re-walk)
    assert counts["rewalks"] == 0
    assert counts["syncs"] <= 1 + m.pairs_batches + path
    monkeypatch.setenv("DECIPHON_SYNC_DEBUG", "1")
    serial, serial_got = scan(planted, tmp_path / "serial", scanner=sc)
    assert serial_got == want
    assert serial.metrics.counts["launches"] == launches
    torch.cuda.synchronize()
