"""The scan's own tracing (deciphon_tpu_torch/logging.py ScanMetrics):
spans on torch.profiler's clock while a profiler records and nothing more
while none does, per-run counts, the always-on bucket ledger, and the
history of finished runs.

CPU tests on a planted scan (three profiles, five reads) through the
plain versions, and one card test, skipped without a card, that holds a
phase-1 kernel's launch inside the `deciphon.dispatch` span that issued
it.  They import nothing but the port; on the card's machine run them as

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_tracing.py
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deciphon_tpu_torch import logging as dlog
from deciphon_tpu_torch.ops import traceback as tb
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.profile import sample_profile
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as ts
from deciphon_tpu_torch.scan.sequence import Sequence
from deciphon_tpu_torch.workload import planted_read, random_bases

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

# the pipeline's spans directly inside `run`
TOP = {"setup", "windowing", "assemble", "phase1_dispatch",
       "phase1_collect", "lrt", "phase2_dispatch", "phase2_fetch",
       "phase2_decode", "write", "release"}


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


class SpyRecordFunction:
    """Counts record_function ranges and opens the real one."""

    calls = 0

    def __init__(self, name):
        type(self).calls += 1
        self.real = REAL_RECORD_FUNCTION(name)

    def __enter__(self):
        return self.real.__enter__()

    def __exit__(self, *exc):
        return self.real.__exit__(*exc)


REAL_RECORD_FUNCTION = torch.autograd.profiler.record_function


def test_no_profiler_no_spans(planted, tmp_path, monkeypatch):
    """Without a profiler a run opens no record_function range and keeps
    no span list, yet every wall and count is there; under one, every
    span opens one range."""
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        SpyRecordFunction)
    SpyRecordFunction.calls = 0
    sc, _ = scan(planted, tmp_path / "off")
    m = sc.metrics
    assert SpyRecordFunction.calls == 0
    assert m.spans is None and m.unspanned_s() is None
    assert TOP | {"run", "pack", "dispatch", "collect"} <= set(m.walls)
    assert set(m.longest) == set(m.walls)
    assert all(0 <= m.longest[k] <= m.walls[k] for k in m.walls)
    assert m.counts["syncs"] > 0 and m.counts["d2h_bytes"] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        sc, _ = scan(planted, tmp_path / "on", scanner=sc)
    assert SpyRecordFunction.calls == len(sc.metrics.spans) > 0


def user_spans(prof, path) -> list:
    """(name, start, end) in us of the trace's deciphon.* ranges on the
    host, from its Chrome export (quicker to read than prof.events())."""
    prof.export_chrome_trace(str(path))
    return [(e["name"], e["ts"], e["ts"] + e["dur"])
            for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation"
            and e["name"].startswith("deciphon.")]


def test_spans_nest_in_run(planted, tmp_path):
    """Under torch.profiler every deciphon.* range lies inside the one
    deciphon.run, the in-memory spans are those ranges, each span but
    `run` has a parent that holds it, and the run's host seconds outside
    its child spans are under 2 % of it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sc, _ = scan(planted, tmp_path / "out")
    m = sc.metrics
    events = user_spans(prof, tmp_path / "trace.json")
    runs = [e for e in events if e[0] == "deciphon.run"]
    assert len(runs) == 1
    lo, hi = runs[0][1:]
    assert all(lo <= a <= b <= hi for _, a, b in events)
    assert sorted(e[0] for e in events) == sorted(
        "deciphon." + s[0] for s in m.spans)
    for name, t0, t1, parent, run_id, wave in m.spans:
        assert t0 <= t1 and run_id == m.run_id
        if name == "run":
            assert parent is None
            continue
        p = m.spans[parent]
        assert p[1] <= t0 <= t1 <= p[2]
        if p[0] == "run":
            assert name in TOP
        if name.startswith(("phase1_", "phase2_", "lrt", "assemble")):
            assert isinstance(wave, int)
    top = {s[0] for s in m.spans if s[3] is not None
           and m.spans[s[3]][0] == "run"}
    assert top == TOP
    assert 0 <= m.unspanned_s() < 0.02 * m.walls["run"]
    # phase-2 spans of a wave carry the wave its phase 1 ran in
    waves = {s[0]: s[5] for s in m.spans}
    assert waves["phase2_decode"] == waves["lrt"] == waves["phase1_collect"]


def test_walls_equal_sums_of_spans(planted, tmp_path):
    """Each wall is the sum of its spans' durations, and `longest` the
    longest of them."""
    with profile(activities=[ProfilerActivity.CPU]):
        sc, _ = scan(planted, tmp_path / "out")
    m = sc.metrics
    for name in m.walls:
        d = [(s[2] - s[1]) * 1e-9 for s in m.spans if s[0] == name]
        assert m.walls[name] == pytest.approx(sum(d), rel=1e-9, abs=1e-12)
        assert m.longest[name] == pytest.approx(max(d), rel=1e-9)


def test_counts_are_the_run_deltas(planted, tmp_path, monkeypatch):
    """`launches` and `rewalks` are the run's differences of LAUNCHES and
    REWALKS: the walk is counted as the card counts it, and walked with
    a few steps so that every survivor is walked again; the products are
    those of a plain scan, and a second run counts the same again."""
    _, want = scan(planted, tmp_path / "plain")
    walk = tb.walk

    def short_walk(xn, nd, rows, lengths, max_steps):
        vk.LAUNCHES["walk"] += 1
        return walk(xn, nd, rows, lengths, 8)

    monkeypatch.setattr(ts, "walk", short_walk)  # rewalk's stays whole
    sc = None
    got = []
    for i in range(2):
        launches, rewalks = dict(vk.LAUNCHES), tb.REWALKS["survivors"]
        sc, products = scan(planted, tmp_path / f"r{i}", scanner=sc)
        assert products == want
        m = sc.metrics
        delta = {k: v - launches[k] for k, v in vk.LAUNCHES.items()
                 if v != launches[k]}
        assert m.counts["launches"] == delta and delta["walk"] > 0
        assert m.counts["rewalks"] == tb.REWALKS["survivors"] - rewalks > 0
        got.append(m.counts)
    assert got[0] == got[1]


def test_bucket_cells_without_sync_debug(planted, tmp_path, monkeypatch):
    """The bucket ledger is kept at every launch: with DECIPHON_SYNC_DEBUG
    off it is the one the same scan keeps with it on, B2's path_ entries
    too; only the switch adds a wall a bkt_ name."""
    monkeypatch.setenv("DECIPHON_SYNC_DEBUG", "1")
    on, on_products = scan(planted, tmp_path / "on")
    monkeypatch.delenv("DECIPHON_SYNC_DEBUG")
    off, off_products = scan(planted, tmp_path / "off")
    assert on_products == off_products
    cells = off.metrics.bucket_cells
    assert cells == on.metrics.bucket_cells
    assert any(n.startswith("bkt_") for n in cells)
    assert any(n.startswith("path_") for n in cells)
    assert all(0 < t <= p for t, p, _ in cells.values())
    bkt = {n for n in cells if n.startswith("bkt_")}
    assert bkt <= set(on.metrics.walls)
    assert not bkt & set(off.metrics.walls)


def test_history_lines_up_with_runs(planted, tmp_path):
    """HISTORY ends with the finished runs' ScanMetrics in order, the very
    objects the scanner held, and holds at least 1,000 runs."""
    sc, mine = None, []
    for i in range(3):
        sc, _ = scan(planted, tmp_path / f"r{i}", scanner=sc)
        mine.append(sc.metrics)
    assert all(a is b for a, b in zip(list(dlog.HISTORY)[-3:], mine))
    assert [m.run_id for m in mine] == sorted({m.run_id for m in mine})
    assert dlog.HISTORY.maxlen >= 1000


def test_timed_without_metrics():
    """A scorer used outside a Scanner has no ScanMetrics: `timed` then
    does nothing, and the transfers count nowhere."""
    with dlog.timed(None, "pack"):
        pass
    a = np.arange(6, dtype=np.int32)
    (t,) = dlog.to_device("cpu", a)
    assert (dlog.to_host(t) == a).all()


@pytest.mark.cuda
def test_dispatch_span_holds_its_launches(planted, tmp_path):
    """On the card, each phase-1 score kernel's launch (the runtime call
    with its correlation id) lies inside a deciphon.dispatch span, and the
    kernel starts after its launch, all on the profiler's clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    sc, _ = scan(planted, tmp_path / "warm", device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scan(planted, tmp_path / "out", scanner=sc)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == "deciphon.dispatch"
             and e.get("cat") == "user_annotation"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "score_" in e["name"]]
    assert spans and kernels
    for k in kernels:
        launch = launches[k["args"]["correlation"]]
        t = launch["ts"]
        assert any(a <= t <= b for a, b in spans), k["name"]
        assert k["ts"] >= t
