"""The harness on the CPU at a tiny size: the seed's batches, the work the
rooflines divide, the reference against the program's CPU route, the
control, the faults the comparison must catch, and the import check."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import check, model, traffic, yardstick
from portbench.run import run_cell

REPO = Path(__file__).resolve().parents[2]
BIG_SEED = 2**31 + 12345


def _products(tiny, seed, tmp_path):
    """The program's CPU route over the tiny cell's whole first batch."""
    from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner
    from deciphon_tpu_torch.scan.sequence import Sequence

    cfg, tr = tiny["config"], tiny["traffic"]
    hmms = model.draw(cfg, seed)
    served = [traffic.batch(cfg, hmms, tr, seed, 0)]
    scanner = Scanner(model.press_program(cfg, hmms),
                      ScanConfig(device="cpu"))
    seqs = [Sequence.make(i, f"r{i}", r)
            for i, r in enumerate(served[0].reads)]
    path = scanner.run(seqs, str(tmp_path / "out"))
    return cfg, hmms, served, scanner, Path(path).read_text()


def _stream(cfg, tr, seed, n=3):
    hmms = model.draw(cfg, 1)
    return [traffic.batch(cfg, hmms, tr, seed, j) for j in range(n)]


def test_same_batches_from_same_seed(tiny):
    cfg, tr = tiny["config"], tiny["traffic"]
    a, b, c = (_stream(cfg, tr, s) for s in (BIG_SEED, BIG_SEED, 7))
    assert [x.reads for x in a] == [x.reads for x in b]
    assert [x.planted for x in a] == [x.planted for x in b]
    assert [x.reads for x in a] != [x.reads for x in c]
    # a stream's batches differ from each other and from the warm-up's
    hmms = model.draw(cfg, 1)
    warm = traffic.warmup_batch(cfg, hmms, tr, BIG_SEED)
    assert len({tuple(x.reads) for x in a + [warm]}) == len(a) + 1
    # every seed: the same read lengths and planted count
    assert ([[len(r) for r in x.reads] for x in a]
            == [[len(r) for r in x.reads] for x in c])
    assert ([sum(p is not None for p in x.planted) for x in a]
            == [sum(p is not None for p in x.planted) for x in c])


def test_planted_reads_anywhere_in_a_batch(tiny):
    """Half of each batch planted: over a stream, every position of a
    batch carries a planted read in some batch and a random one in
    another, and every batch plants the same spread of profiles."""
    cfg, tr = tiny["config"], tiny["traffic"]
    tr["batch"] = [{"length": 400, "count": 6, "planted": 3}]
    stream = _stream(cfg, tr, BIG_SEED, n=24)
    marks = np.array([[p is not None for p in x.planted] for x in stream])
    assert (marks.sum(1) == 3).all()
    assert marks.any(0).all() and (~marks).any(0).all()
    for x in stream:  # three profiles of three, one of each size
        assert sorted(p[0] for p in x.planted if p is not None) == [0, 1, 2]


def test_sample_covers_reads_uniformly(tiny):
    """The checked reads come from every served batch, each against its
    planted profile and the evenly spaced profiles, plus the lines the
    program wrote of it."""
    cfg, tr = tiny["config"], tiny["traffic"]
    tr["check"] = {"reads": 8, "profiles": 2, "lines": 0}
    served = _stream(cfg, tr, BIG_SEED, n=6)
    hmms = model.draw(cfg, 1)
    header = "\t".join(["c"] * 12) + "\n"
    row = "\t".join(["3", "0", "0", "1", "x", "0", "1", hmms[2].name, "x",
                     "1.0", "x", "s"]) + "\n"
    products = [header + row] * len(served)
    triples = check.sample(tr, served, products, hmms, BIG_SEED)
    reads = {t[:2] for t in triples}
    assert len(reads) == 8
    assert len({b for b, _ in reads}) > 1
    for b, i in reads:
        mine = {p for bb, ii, p in triples if (bb, ii) == (b, i)}
        assert len(mine) >= 2
        if served[b].planted[i] is not None:
            assert served[b].planted[i][0] in mine
        if i == 3:
            assert 2 in mine


def test_same_parameters_from_same_seed(tiny):
    cfg = tiny["config"]
    a, b = model.draw(cfg, BIG_SEED), model.draw(cfg, BIG_SEED)
    for x, y in zip(a, b):
        assert np.array_equal(x.match_lprobs, y.match_lprobs)
        assert np.array_equal(x.trans, y.trans)
    # probabilities: a node's seven transitions sum to one (the rule of
    # sample_profile); the BEGIN line has no DD, the last node no MD, DD
    t = np.exp(a[0].trans.astype(np.float64))
    assert np.allclose(t.sum(1), 1, atol=1e-5)
    assert t[0, 6] == 0 and t[-1, 2] == 0 and t[-1, 6] == 0
    assert np.allclose(np.exp(a[0].match_lprobs.astype(np.float64)).sum(1),
                       1, atol=1e-5)


def test_mutate_rates():
    rng = np.random.default_rng(0)
    x = np.zeros(200_000, np.int64)
    y = traffic.mutate(rng, x, 0.3)
    # an insertion adds a base and a deletion removes one: equal rates
    assert abs(len(y) - len(x)) < 0.01 * len(x)
    assert np.array_equal(traffic.mutate(rng, x[:50], 0.0), x[:50])


def test_score_work_by_hand(tiny, tmp_path):
    """ScanMetrics.cells of a scan whose windows are whole reads (K x 50
    past every read's length), and the least time from it, by hand."""
    cfg, hmms, served, scanner, _ = _products(tiny, 3, tmp_path)
    ks = model.core_sizes(cfg)
    lens = [len(r) for r in served[0].reads]
    assert all(k * 50 >= L for k in ks for L in lens)
    cells = yardstick.batch_cells(ks, lens)
    assert cells == sum(L * k for k in ks for L in lens)
    assert scanner.metrics.cells == 5 * cells  # the program's own count
    ops = 34 * cells
    nbytes = sum(ks) * (1364 + 9) * 4 + sum(lens) * 20
    assert yardstick.score_least_seconds(cells, ks, sum(lens)) == (
        pytest.approx(max(ops / 67e12, nbytes / 3.35e12), rel=1e-12))


def test_window_cells_by_hand():
    """A read longer than its windows: K 20 gives windows of 1000 nt that
    back up 80 nt, over 2500 nt: [0, 1000), [921, 1921), [1842, 2500)."""
    assert yardstick.pair_cells(20, 2500) == (1000 + 1000 + 658) * 20
    assert yardstick.pair_cells(100, 2500) == 2500 * 100


def test_path_work_by_hand():
    L, K = 400, 60
    ops = 98 * L * K
    nbytes = K * 1373 * 4 + L * 20 + L * (K + 1) * 4
    assert yardstick.path_least_seconds(L, K) == pytest.approx(
        max(ops / 67e12, nbytes / 3.35e12), rel=1e-12)


def test_kernel_names_match_families():
    for name in ("void score_chained_kernel<false, 4, true>(float const*)",
                 "_Z18score_pairs_kernelILb0ELi4EEvPKf",
                 "score_packed_chained_kernel(int)"):
        assert yardstick.SCORE_RE.search(name)
        assert not yardstick.PATH_RE.search(name)
    assert yardstick.PATH_RE.search("void path_kernel<true>(int)")
    assert not yardstick.SCORE_RE.search("void walk_kernel(int)")
    assert not yardstick.SCORE_RE.search("void score_grid_kernel<false>()")


@pytest.mark.parametrize("seed", [1, BIG_SEED])
def test_reference_matches_program_cpu(tiny, seed, tmp_path):
    """The reference's lines of every pair of a batch equal the program's
    CPU route's, the LRT within its printed rounding (on seeds whose
    planted stretches score above the null, so that there are lines)."""
    cfg, hmms, served, _, text = _products(tiny, seed, tmp_path)
    triples = [(0, i, p) for i in range(len(served[0].reads))
               for p in range(len(hmms))]
    prog = check.program_lines([text], triples, hmms)
    ref = check.reference_lines(cfg, hmms, served, triples, "cpu")
    n = check.compare(prog, ref)
    assert n["lines_reference"] > 0
    assert n["lines_differing"] == 0
    assert n["lrt_gap"] <= 0.05 + 1e-9


def test_control_fails(tiny):
    """The reference in bfloat16 in the program's place fails the limits
    (at the tiny size, on three seeds)."""
    from portbench.control import control

    for seed in (1, 2, BIG_SEED):
        assert control(tiny, seed, "cpu")["fails"]


def _half(scanner):
    run = scanner.run

    def half(seqs, out, **kw):
        return run(seqs[:len(seqs) // 2], out, **kw)

    scanner.run = half


def _unchanged(scanner):
    run = scanner.run

    def empty(seqs, out, **kw):
        return run([], out, **kw)

    scanner.run = empty


def _silent(scanner):
    """The timed path writes nothing at all (a write lost or deferred)."""

    def silent(seqs, out, **kw):
        return str(Path(out) / "products.tsv")

    scanner.run = silent


def _altered(scanner):
    add = scanner._add_line

    def altered(writer, line, order, pair):
        line.lrt += 1.0
        return add(writer, line, order, pair)

    scanner._add_line = altered


def _altered_step(scanner):
    add = scanner._add_line

    def altered(writer, line, order, pair):
        i = next(i for i, s in enumerate(line.steps) if s.count(",") == 3
                 and s.split(",")[3])
        f, state, codon, amino = line.steps[i].split(",")
        line.steps[i] = f"{f},{state},{codon},{'W' if amino != 'W' else 'Y'}"
        return add(writer, line, order, pair)

    scanner._add_line = altered


# a seed on which the tiny cell's planted stretches give lines in both
# halves of a batch, so that every fault below has a line to lose
FAULT_SEED = 1


def test_sound_run_is_correct(tiny):
    out = run_cell(tiny, FAULT_SEED, 0.01, False, device="cpu")
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["metrics"]["reads_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [_unchanged, _silent, _half, _altered,
                                   _altered_step],
                         ids=["unchanged", "silent", "half", "altered_lrt",
                              "altered_amino"])
def test_fault_is_caught(tiny, fault):
    """The timed path broken underneath: `correct` comes out false."""
    out = run_cell(tiny, FAULT_SEED, 0.01, False, device="cpu", hook=fault)
    assert not out["correct"], out["checks"]


def test_no_jax_in_a_run(tiny):
    """A run in a fresh process loads no module whose top-level name is
    jax, jaxlib, flax or deciphon_tpu."""
    code = (
        "import json, sys\n"
        "from portbench.run import run_cell, forbidden_modules\n"
        "import portbench.control, portbench.trace\n"
        f"spec = json.loads({json.dumps(json.dumps(tiny))})\n"
        "run_cell(spec, 5, 0.01, False, device='cpu')\n"
        "print(json.dumps(forbidden_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    tops = set(json.loads(lines[-1]))
    assert "deciphon_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "deciphon_tpu"}


def test_harness_imports_nothing_forbidden():
    """No source file of the harness names a forbidden top-level module."""
    pat = __import__("re").compile(
        r"^\s*(?:from|import)\s+(jax|jaxlib|flax|deciphon_tpu)(?:[.\s]|$)",
        __import__("re").M)
    for f in (REPO / "portbench").rglob("*.py"):
        if "tests" in f.parts:
            continue
        assert not pat.search(f.read_text()), f


def test_no_card_no_result():
    """Without a card the command prints no result and fails."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "pfam200.r10k", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tiny, cuda_device):
    out = run_cell(tiny, BIG_SEED, 0.5, True, device=cuda_device)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
