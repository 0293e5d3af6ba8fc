"""The port's worker daemons (`worker/`) and the worker's confirmation
against the reference's: `press()` in a thread with its progress,
`launch_scanner` and `ScannerDaemon` (queued requests, interrupts), and
`WorkerLoop(confirm="native", device="cpu")` against the reference's
`WorkerLoop(confirm="native", engine="jax")`.

Data as tests/test_torch_services.py: three amino profiles as HMMER3
text and reads planted from the pressed profiles.  Products are compared
byte for byte; confirmed e-values within PERF.md section 2's limit, as
tests/test_torch_cli.py compares them.
"""

import math
import threading
import zipfile
from pathlib import Path

import pytest
import torch

import deciphon_tpu.hmmer.forward as r_forward
import deciphon_tpu.scan.sequence as r_sequence
import deciphon_tpu.worker as r_worker
import deciphon_tpu.worker.progressor as r_progressor
import deciphon_tpu_torch.hmmer.forward as p_forward
import deciphon_tpu_torch.scan.sequence as p_sequence
import deciphon_tpu_torch.worker as p_worker
import deciphon_tpu_torch.worker.progressor as p_progressor
from deciphon_tpu_torch.hmmfile import read_hmm
from deciphon_tpu_torch.scan.pipeline import Scanner
from test_torch_cli import ATOL, RTOL, PartsRecorder
from test_torch_services import PORT, REF, data, flow  # noqa: F401

torch.set_num_threads(1)

TIMEOUT = 300  # seconds any one request may take on the CPU


def sequences(mod, data, n=3) -> list:
    return [mod.Sequence.make(i + 1, s["name"], s["data"])
            for i, s in enumerate(data["seqs"][:n])]


def members(dcs) -> dict:
    """{member path below the archive's root: bytes} of a snap."""
    with zipfile.ZipFile(dcs) as z:
        return {n.split("/", 1)[1]: z.read(n) for n in z.namelist()
                if not n.endswith("/")}


@pytest.fixture(scope="module")
def ref_snaps(data, tmp_path_factory):
    """The reference's launch_scanner(engine="jax") on all the reads and
    on the first, two requests queued at once."""
    d = tmp_path_factory.mktemp("ref_daemon")
    with r_worker.launch_scanner(str(data["dcp"]), engine="jax") as daemon:
        progs = [daemon.put(str(d / f"{i}.dcs"), sequences(r_sequence, data,
                                                             n))
                 for i, n in enumerate((3, 1))]
        return [members(p.result(timeout=TIMEOUT)) for p in progs]


def test_press_worker_matches_reference(data, tmp_path):
    """press() reports progress rising to 100 and writes the reference's
    .dcp bytes."""
    dcps = {}
    for name, mod in (("port", p_worker), ("ref", r_worker)):
        out = str(tmp_path / f"{name}.dcp")
        prog = mod.press(str(data["hmm"]), out, gencode_id=1, epsilon=0.01)
        values = list(prog.as_progress())
        assert values[-1] == 100 and values == sorted(values)
        assert prog.result(timeout=TIMEOUT) == out
        dcps[name] = Path(out).read_bytes()
    assert dcps["port"] == dcps["ref"] == data["dcp"].read_bytes()


@pytest.mark.parametrize("what", ["missing", "no profile"])
def test_press_worker_error_matches_reference(tmp_path, what):
    """A file that is missing or holds no profile makes press() raise the
    reference's error type and message."""
    src = tmp_path / "in.hmm"
    if what == "no profile":
        src.write_text("not a profile\n")
    errors = []
    for mod in (p_worker, r_worker):
        prog = mod.press(str(src), str(tmp_path / "x.dcp"))
        exc = prog.exception(timeout=TIMEOUT)
        assert exc is not None
        errors.append((type(exc).__name__, str(exc)))
    assert errors[0] == errors[1]
    assert errors[0][0] == ("FileNotFoundError" if what == "missing"
                            else "ValueError")


@pytest.mark.parametrize("engine", ["kernels", "kernels-multi", "torch",
                                    "native"])
def test_scanner_daemon_matches_reference(data, ref_snaps, tmp_path,
                                          engine):
    """launch_scanner(dcp, device="cpu") serves two queued requests with
    the reference's launch_scanner(dcp, engine="jax") snaps, on the
    daemon's own thread, its progress reaching 100."""
    with p_worker.launch_scanner(str(data["dcp"]), engine=engine,
                                 device="cpu") as daemon:
        assert daemon.device == torch.device("cpu")
        progs = [daemon.put(str(tmp_path / f"{i}.dcs"),
                            sequences(p_sequence, data, n))
                 for i, n in enumerate((3, 1))]
        got = [members(p.result(timeout=TIMEOUT)) for p in progs]
        assert all(p.progress == 100 for p in progs)
    assert got == ref_snaps
    rows = got[0]["products.tsv"].decode().splitlines()[1:]
    assert {r.split("\t")[7] for r in rows} == {"PEAKED40", "PEAKED42"}
    assert not any(Path(f"{tmp_path}/{i}.dcs.work").exists() for i in (0, 1))


def held(daemon):
    """Make the daemon's next scans wait, once each has started, until the
    test lets them go: returns (started, go) events."""
    run = daemon.scanner.run
    started, go = threading.Event(), threading.Event()

    def wait_then_run(*a, **kw):
        started.set()
        assert go.wait(TIMEOUT)
        return run(*a, **kw)

    daemon.scanner.run = wait_then_run
    return started, go


def interrupted(mod, seq_mod, dcp, tmp: Path, **kw) -> tuple:
    """Interrupt a queued request (before its scan starts) and a running
    one (before its first wave); then serve one more request.  Returns the
    two exceptions and the last snap's products."""
    seqs = [seq_mod.Sequence.make(1, "r", "ACGT" * 60)]
    with mod.launch_scanner(dcp, **kw) as daemon:
        started, go = held(daemon)
        first = daemon.put(str(tmp / "first.dcs"), seqs)
        assert started.wait(TIMEOUT)
        queued = daemon.put(str(tmp / "queued.dcs"), seqs)
        queued.interrupt()
        go.set()
        first.result(timeout=TIMEOUT)
        excs = [queued.exception(timeout=TIMEOUT)]
        started, go = held(daemon)
        running = daemon.put(str(tmp / "running.dcs"), seqs)
        assert started.wait(TIMEOUT)
        running.interrupt()
        go.set()
        excs.append(running.exception(timeout=TIMEOUT))
        del daemon.scanner.run
        after = daemon.put(str(tmp / "after.dcs"), seqs)
        products = members(after.result(timeout=TIMEOUT))["products.tsv"]
    assert not (tmp / "queued.dcs").exists()
    assert not (tmp / "running.dcs").exists()
    return excs, products


def test_scanner_daemon_interrupt_matches_reference(data, tmp_path):
    """An interrupted request ends with the port's Interrupted (the
    progressor's before the scan starts, the Scanner's between its waves),
    as the reference's ends with its own, and the daemon serves the next
    request."""
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    got, p_products = interrupted(
        p_worker, p_sequence, str(data["dcp"]), tmp_path / "p",
        device="cpu")
    want, r_products = interrupted(
        r_worker, r_sequence, str(data["dcp"]), tmp_path / "r",
        engine="jax")
    assert isinstance(got[0], p_progressor.Interrupted)
    assert isinstance(got[1], Scanner.Interrupted)
    assert isinstance(want[0], r_progressor.Interrupted)
    assert [(type(e).__name__, str(e)) for e in got] == \
        [(type(e).__name__, str(e)) for e in want]
    assert p_products == r_products


def test_progressor_matches_reference():
    for mod in (p_progressor, r_progressor):
        prog = mod.Progressor()
        prog.set_progress(150)
        assert prog.progress == 100
        prog.interrupt()
        with pytest.raises(mod.Interrupted, match="operation interrupted"):
            prog.check_interrupted()


def test_worker_confirm_native_matches_reference(data, tmp_path,
                                                 monkeypatch):
    """WorkerLoop(confirm="native", device="cpu") keeps and drops the
    reference's WorkerLoop(confirm="native", engine="jax") hits: every
    products.tsv column but the e-value byte-identical, each e-value
    within the tolerance its hits carry plus the %.2g print's rounding."""
    rec, tsv = {}, {}
    for name, sched_mod, client, mod, kw in (
            ("port", PORT["sched"], PORT, p_forward,
             dict(engine="kernels", device="cpu", confirm="native")),
            ("ref", REF["sched"], REF, r_forward,
             dict(engine="jax", confirm="native"))):
        rec[name] = PartsRecorder(mod, monkeypatch)
        tmp = tmp_path / name
        tmp.mkdir()
        tsv[name] = flow(sched_mod, client, kw, data, tmp)["products"]
    pp, rp = rec["port"].parts, rec["ref"].parts
    assert len(pp) == len(rp) > 0
    for a, b in zip(pp, rp):
        assert a == pytest.approx(b, rel=RTOL, abs=ATOL)
    lam = max(h.stats["FORWARD"][1] for h in read_hmm(str(data["hmm"])))
    bits = max(ATOL + RTOL * (abs(b[0]) + abs(b[1])) / p_forward.LN2
               for b in rp)
    rows = [[r.split("\t") for r in t.decode().splitlines()]
            for t in (tsv["port"], tsv["ref"])]
    assert [r[:10] + r[11:] for r in rows[0]] == \
        [r[:10] + r[11:] for r in rows[1]]
    assert len(rows[0]) > 1  # a hit kept
    for a, b in zip(rows[0][1:], rows[1][1:]):
        ea, eb = math.log(float(a[10])), math.log(float(b[10]))
        assert abs(ea - eb) <= lam * bits + 2 * math.log(1.05), (a[10], b[10])


def test_daemon_enters_the_scanners_card(monkeypatch):
    """The daemon's thread runs the Scanner inside the Scanner's device:
    a bare "cuda" resolved on the building thread (here the device calls
    are spied, on the CPU)."""
    entered = []

    class Spy:
        def __init__(self, dev):
            entered.append(dev)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    import deciphon_tpu_torch.worker.daemons as daemons

    scanner = type("S", (), {"device": torch.device("cuda")})()
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "device", Spy)
    daemon = daemons.ScannerDaemon(scanner)
    daemon.close()
    assert daemon.device == torch.device("cuda", 3)
    assert entered == [torch.device("cuda", 3)]
