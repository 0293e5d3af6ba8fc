"""The port's press, `.dcp` container and command line against the
reference's: `.dcp` bytes, `press -> scan --device cpu -> see` through
both CLIs (engines `kernels`, `torch` and `native` against the
reference's `--engine jax`), the hmmpgmd client against the fake daemon,
`--confirm native`, and the CLI's refusals.

Data: `HMM_TEXT` (tests/test_torch_copies.py), five amino profiles
written with `workload.hmm_text` (peaked_hmm and sample_hmm, K 9, 50, 95,
200 and 600), reads planted from the pressed profiles and a consensus
read of tests/data_consensus.json.  Products are compared byte for byte;
confirmed e-values within PERF.md section 2's limit (log-E within atol
1e-3 + rtol 1e-4 (|Forward| + |null2 bias|) lambda / ln 2, as
tests/test_torch_hmmer.py).
"""

import json
import math
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import deciphon_tpu.cli as r_cli
import deciphon_tpu.hmmer.daemon as r_daemon
import deciphon_tpu.hmmer.forward as r_forward
import deciphon_tpu.hmmer.h3result as r_h3
import deciphon_tpu.io.dcp as r_dcp
import deciphon_tpu.ops.costs as r_costs
import deciphon_tpu.press as r_press
import deciphon_tpu_torch.cli as p_cli
import deciphon_tpu_torch.hmmer.daemon as p_daemon
import deciphon_tpu_torch.hmmer.forward as p_forward
import deciphon_tpu_torch.hmmer.h3result as p_h3
import deciphon_tpu_torch.io.dcp as p_dcp
import deciphon_tpu_torch.ops.costs as p_costs
import deciphon_tpu_torch.press as p_press
from deciphon_tpu_torch.convert import frame_profile_from_arrays
from deciphon_tpu_torch.hmmfile import read_hmm
from deciphon_tpu_torch.profile import ENTRY_DIST_OCCUPANCY, press_profile
from deciphon_tpu_torch.workload import (hmm_text, peaked_hmm, planted_read,
                                         random_bases, sample_hmm)
from test_torch_copies import HMM_TEXT, same, same_fields

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 1e-3


def five_hmms():
    """Five amino profiles, K 9, 50, 95, 200 and 600: the peaked ones
    confirm, sample_hmm's never do."""
    return [peaked_hmm(40, 9), sample_hmm(41, 50)[0], peaked_hmm(42, 95),
            sample_hmm(43, 200)[0], peaked_hmm(44, 600)]


def planted_fasta(profiles) -> str:
    """Reads carrying the pressed profiles' domains: the whole of profile
    2 (K 95) and 0 (K 9), nodes 200-300 of profile 4 (K 600); a random
    read; the first consensus read of tests/data_consensus.json."""
    rng = np.random.default_rng(5)
    reads = [planted_read(rng, profiles[2], 400, noise=0.01),
             planted_read(rng, profiles[4], 450, noise=0.01,
                          nodes=(200, 300)),
             planted_read(rng, profiles[0], 200, noise=0.01),
             random_bases(rng, 300)]
    with open(HERE / "data_consensus.json") as fp:
        cons = json.load(fp)[0]
    names = [f"r{i} planted" for i in range(len(reads))] + [cons["name"]]
    return "".join(f">{n}\n{s}\n" for n, s in zip(names, reads
                                                  + [cons["seq"]]))


def invoke(cli, args):
    res = CliRunner().invoke(cli, [str(a) for a in args])
    assert res.exit_code == 0, (res.output, res.exception)
    return res.output


def members(dcs) -> dict:
    """{member name: bytes} of a snap archive (its zip timestamps
    aside)."""
    with zipfile.ZipFile(dcs) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """The five profiles pressed through both CLIs (gencode 1), and the
    planted reads as FASTA: {"hmm", "dcp", "ref_dcp", "fna", "dir"}."""
    d = tmp_path_factory.mktemp("cli")
    (d / "db.hmm").write_text(hmm_text(five_hmms()))
    invoke(p_cli.cli, ["press", d / "db.hmm", 1, "--no-progress"])
    invoke(r_cli.cli, ["press", d / "db.hmm", 1, "--no-progress",
                       "--output", d / "ref.dcp"])
    _, profiles = p_dcp.read_dcp_profiles(str(d / "db.dcp"))
    (d / "reads.fna").write_text(planted_fasta(profiles))
    return dict(hmm=d / "db.hmm", dcp=d / "db.dcp", ref_dcp=d / "ref.dcp",
                fna=d / "reads.fna", dir=d)


@pytest.fixture(scope="module")
def ref_scan(db):
    """The reference CLI's `--engine jax` scan and its `see` text."""
    dcs = db["dir"] / "ref_jax.dcs"
    invoke(r_cli.cli, ["scan", db["ref_dcp"], db["fna"], "--snap", dcs,
                       "--engine", "jax", "--no-progress"])
    return members(dcs), invoke(r_cli.cli, ["see", dcs])


def rename(mem: dict, old: str, new: str) -> dict:
    """Snap members with their root directory renamed."""
    return {new + k[len(old):]: v for k, v in mem.items()}


# ---------------------------------------------------------------------------
# press and the .dcp container
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gencode,epsilon", [(1, 0.01), (1, 0.1),
                                             (11, 0.01), (11, 0.1)])
@pytest.mark.parametrize("text", ["tiny", "five"])
def test_press_writes_reference_dcp_bytes(tmp_path, text, gencode, epsilon):
    """The port's press writes the reference press's .dcp, byte for byte,
    and reads back what it pressed."""
    src = tmp_path / "db.hmm"
    src.write_text(HMM_TEXT if text == "tiny" else hmm_text(five_hmms()))
    seen = []
    got = p_press.press(str(src), str(tmp_path / "p.dcp"), gencode, epsilon,
                        progress=lambda d, t: seen.append((d, t)))
    want = r_press.press(str(src), str(tmp_path / "r.dcp"), gencode, epsilon)
    n = 1 if text == "tiny" else 5
    assert seen[-1] == (n, n)
    assert Path(got).read_bytes() == Path(want).read_bytes()
    hdr, back = p_dcp.read_dcp_profiles(got)
    assert hdr.epsilon == pytest.approx(epsilon) and len(back) == n
    assert hdr.entry_dist == ENTRY_DIST_OCCUPANCY
    for disk, hmm in zip(back, read_hmm(str(src))):
        fresh = press_profile(hmm, gencode, epsilon)
        assert disk.accession == fresh.accession
        assert np.array_equal(disk.trans[1:], fresh.trans[1:])
        assert np.array_equal(disk.match_emission, fresh.match_emission)
        assert np.array_equal(disk.BMk, fresh.BMk)


@pytest.mark.parametrize("what", ["chunked", "random_access", "corrupt",
                                  "costs", "context"])
def test_dcp_container(db, tmp_path, what):
    """The chunked writer and random access of both packages against the
    sequential read; a corrupted byte raises DcpFormatError in both; costs
    built from the read-back .dcp (trans[0] left -inf) equal those of a
    fresh press and the reference's; PressContext streams the press."""
    _, profiles = p_dcp.read_dcp_profiles(str(db["dcp"]))
    if what == "chunked":
        for mod in (p_dcp, r_dcp):
            def write(path, split):
                w = mod.DcpWriter(str(path), entry_dist=2, epsilon=0.01,
                                  split_size=split)
                w.set_has_ga(False)
                for p in profiles:
                    w.pack_profile(p)
                nchunks = len(w._chunk_paths)
                w.close()
                return nchunks

            assert write(tmp_path / "chunked.dcp", 1) >= len(profiles)
            assert write(tmp_path / "plain.dcp", None) == 1
            assert ((tmp_path / "chunked.dcp").read_bytes()
                    == (tmp_path / "plain.dcp").read_bytes()
                    == db["dcp"].read_bytes())
            w = mod.DcpWriter(str(tmp_path / "over.dcp"), 2, 0.01,
                              split_size=1)
            w.MAX_CHUNKS = 3
            w.pack_profile(profiles[0])
            w.pack_profile(profiles[1])
            with pytest.raises(mod.DcpFormatError, match="chunks"):
                w.pack_profile(profiles[2])
    elif what == "random_access":
        with p_dcp.DcpReader(str(db["dcp"])) as r:
            assert r.num_proteins == len(profiles)
            for i in (4, 0, 2):
                assert same_fields(r.read_profile(i), profiles[i])
        with r_dcp.DcpReader(str(db["dcp"])) as r:
            assert same_fields(
                frame_profile_from_arrays(**vars(r.read_profile(3))),
                profiles[3])
    elif what == "corrupt":
        data = bytearray(db["dcp"].read_bytes())
        for at in (0, 3, 10):
            bad = bytearray(data)
            bad[at] ^= 0xFF
            (tmp_path / "bad.dcp").write_bytes(bytes(bad))
            for mod in (p_dcp, r_dcp):
                with pytest.raises(mod.DcpFormatError):
                    mod.read_dcp_profiles(str(tmp_path / "bad.dcp"))
    elif what == "costs":
        _, r_profiles = r_dcp.read_dcp_profiles(str(db["dcp"]))
        for disk, rdisk, hmm in zip(profiles, r_profiles,
                                    read_hmm(str(db["hmm"]))):
            assert np.all(disk.trans[0] == -np.inf)
            fresh = press_profile(hmm, 1, 0.01)
            for mh, h3c in ((True, False), (False, True)):
                got = p_costs.build_costs(disk, mh, h3c)
                assert same_fields(got, p_costs.build_costs(fresh, mh, h3c))
                want = r_costs.build_costs(rdisk, mh, h3c)
                for f in ("core", "match", "null", "background"):
                    assert same(getattr(got, f), getattr(want, f))
    else:
        out = tmp_path / "ctx.dcp"
        with p_press.PressContext(str(db["hmm"]), str(out), gencode_id=1,
                                  epsilon=0.01) as ctx:
            assert ctx.nproteins == 5
            for _ in range(ctx.nproteins):
                ctx.next()
        assert out.read_bytes() == db["dcp"].read_bytes()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_press_writes_reference_bytes(db):
    assert db["dcp"].read_bytes() == db["ref_dcp"].read_bytes()


@pytest.mark.parametrize("engine", ["kernels", "torch", "native"])
def test_cli_scan_and_see_match_reference(db, ref_scan, engine):
    """press -> scan --device cpu -> see through the port's CLI writes the
    reference CLI's snap members (products.tsv byte for byte) and prints
    its `see` text."""
    dcs = db["dir"] / f"{engine}.dcs"
    out = invoke(p_cli.cli, ["scan", db["dcp"], db["fna"], "--snap", dcs,
                             "--engine", engine, "--device", "cpu",
                             "--no-progress"])
    assert out.strip() == f"wrote {dcs}"
    want, want_see = ref_scan
    got = members(dcs)
    assert got == rename(want, "ref_jax", engine)
    tsv = got[f"{engine}/products.tsv"]
    rows = tsv.decode().splitlines()[1:]
    assert {r.split("\t")[7] for r in rows} >= {"PEAKED42", "PEAKED44"}
    assert invoke(p_cli.cli, ["see", dcs]) == want_see
    assert "state" in want_see and "amino" in want_see


def daemon_answer(h3mod):
    """A deterministic hmmpgmd answer from the query alone: no hit, a hit
    whose e-value clamps to 1, or a kept hit."""
    def respond(hmmidx, seq):
        n = len(seq)
        if n % 3 == 0:
            return h3mod.H3Result(stats=h3mod.H3Stats(Z=5.0, nhits=0),
                                  tophits=h3mod.H3TopHits())
        return h3mod.H3Result.single_hit(
            name=f"p{hmmidx}", acc=f"ACC{hmmidx}", score=2.0 * n,
            lnP=-3.0 * (n % 7) - 0.25 * hmmidx, Z=5.0, qlen=100 + hmmidx,
            seqlen=n)
    return respond


def test_cli_hmmer_matches_reference(db):
    """`--hmmer PORT` against the fake daemon: the port's CLI writes the
    reference CLI's snap, h3r files included."""
    snaps = {}
    for name, cli, daemon, h3, dcp, engine in (
            ("port", p_cli.cli, p_daemon, p_h3, db["dcp"], "kernels"),
            ("ref", r_cli.cli, r_daemon, r_h3, db["ref_dcp"], "jax")):
        dcs = db["dir"] / f"hmmer_{name}.dcs"
        with daemon.FakeHMMERDaemon(daemon_answer(h3)) as d:
            args = ["scan", dcp, db["fna"], "--snap", dcs, "--engine",
                    engine, "--hmmer", d.port, "--no-progress"]
            invoke(cli, args + (["--device", "cpu"] if name == "port"
                                else []))
        snaps[name] = members(dcs)
    assert snaps["port"] == rename(snaps["ref"], "hmmer_ref", "hmmer_port")
    assert any(k.endswith(".h3r") for k in snaps["port"])


class PartsRecorder:
    """Patches a package's NativeConfirmer so that its scorer records each
    hit's (Forward nats, null2 bias nats)."""

    def __init__(self, mod, monkeypatch):
        self.parts = []
        base = mod.NativeConfirmer
        parts = self.parts

        class Recording(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                bias = self.scorer.null2_bias_nats

                def spy(p_idx, amino_seq, usages=None):
                    b = bias(p_idx, amino_seq, usages)
                    parts.append((float(usages[0]), float(b)))
                    return b
                self.scorer.null2_bias_nats = spy

        monkeypatch.setattr(mod, "NativeConfirmer", Recording)


def test_cli_confirm_native_matches_reference(db, monkeypatch):
    """`--confirm native` (the .hmm beside the .dcp): the same lines kept,
    every products.tsv column but the e-value byte-identical, the same h3r
    files with close fields, each e-value within the tolerance its hits
    carry plus the %.2g print's rounding (a relative 5e-2 on each side)."""
    rec = {}
    snaps = {}
    for name, cli, mod, engine in (("port", p_cli.cli, p_forward,
                                    "kernels"),
                                   ("ref", r_cli.cli, r_forward, "jax")):
        rec[name] = PartsRecorder(mod, monkeypatch)
        dcs = db["dir"] / f"confirm_{name}.dcs"
        args = ["scan", db["dcp"], db["fna"], "--snap", dcs, "--engine",
                engine, "--confirm", "native", "--no-progress"]
        invoke(cli, args + (["--device", "cpu"] if name == "port" else []))
        snaps[name] = rename(members(dcs), f"confirm_{name}", "s")
    got, want = snaps["port"], snaps["ref"]
    assert got.keys() == want.keys()
    pp, rp = rec["port"].parts, rec["ref"].parts
    assert len(pp) == len(rp) > 0
    hmms = read_hmm(str(db["hmm"]))
    lam = max(h.stats["FORWARD"][1] for h in hmms)
    bits = max(ATOL + RTOL * (abs(b[0]) + abs(b[1])) / p_forward.LN2
               for b in rp)
    for a, b in zip(pp, rp):
        assert a == pytest.approx(b, rel=RTOL, abs=ATOL)
    rows = [[r.split("\t") for r in s["s/products.tsv"].decode()
             .splitlines()] for s in (got, want)]
    assert [r[:10] + r[11:] for r in rows[0]] == \
        [r[:10] + r[11:] for r in rows[1]]
    kept = rows[0][1:]
    assert 0 < len(kept) < len(pp)  # hits kept and hits dropped
    for a, b in zip(kept, rows[1][1:]):
        ea, eb = math.log(float(a[10])), math.log(float(b[10]))
        assert abs(ea - eb) <= lam * bits + 2 * math.log(1.05), (a[10], b[10])
    h3r = [k for k in got if k.endswith(".h3r")]
    assert len(h3r) == len(kept)
    for k in h3r:
        x = p_h3.H3Result.from_blob(got[k]).hits[0]
        y = r_h3.H3Result.from_blob(want[k]).hits[0]
        assert (x.name, x.acc) == (y.name, y.acc)
        assert x.score == pytest.approx(y.score, rel=RTOL, abs=bits)
        assert abs(x.lnP - y.lnP) <= lam * bits


@pytest.mark.parametrize("what", ["overwrite", "gencode", "help", "device",
                                  "no_hmm"])
def test_cli_refusals(db, tmp_path, monkeypatch, what):
    """The scan refuses to overwrite a snap; press refuses an unknown
    genetic code; --help lists the commands; without a card, a scan or a
    warmup on the default device exits non-zero and names the device
    (never falling back to the CPU); --confirm native without the .hmm
    beside the .dcp stops."""
    runner = CliRunner()
    if what == "overwrite":
        dcs = tmp_path / "x.dcs"
        dcs.write_bytes(b"")
        r = runner.invoke(p_cli.cli, ["scan", str(db["dcp"]),
                                      str(db["fna"]), "--snap", str(dcs),
                                      "--device", "cpu", "--no-progress"])
        assert r.exit_code != 0 and "already exists" in r.output
    elif what == "gencode":
        r = runner.invoke(p_cli.cli, ["press", str(db["hmm"]), "99",
                                      "--no-progress"])
        assert r.exit_code != 0 and "unknown genetic code" in r.output
    elif what == "help":
        r = runner.invoke(p_cli.cli, ["--help"])
        assert r.exit_code == 0
        for cmd in ("press", "warmup", "scan", "see", "worker"):
            assert cmd in r.output
        r = runner.invoke(p_cli.cli, ["scan", "--help"])
        assert r.exit_code == 0
        assert "[kernels|kernels-multi|torch|native]" in r.output
        assert "[cuda|cpu]" in r.output
    elif what == "device":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for args in (["scan", str(db["dcp"]), str(db["fna"]), "--snap",
                      str(tmp_path / "y.dcs"), "--no-progress"],
                     ["warmup", str(db["dcp"])]):
            r = runner.invoke(p_cli.cli, args)
            assert r.exit_code != 0
            assert "--device cuda" in r.output and "no CUDA device" in \
                r.output
        assert not (tmp_path / "y.dcs").exists()
    else:
        dcp = tmp_path / "alone.dcp"
        dcp.write_bytes(db["dcp"].read_bytes())
        r = runner.invoke(p_cli.cli, ["scan", str(dcp), str(db["fna"]),
                                      "--snap", str(tmp_path / "z.dcs"),
                                      "--confirm", "native", "--device",
                                      "cpu", "--no-progress"])
        assert r.exit_code != 0 and "alone.hmm" in r.output


def test_cli_warmup_and_profile_dir(db, tmp_path):
    """`warmup` on the CPU, and `scan --profile-dir` writes a
    torch.profiler Chrome trace beside the snap."""
    out = invoke(p_cli.cli, ["warmup", db["dcp"], "--read-length", 300,
                             "--engine", "native", "--device", "cpu"])
    assert out.startswith("warmup done in") and "5 profiles" in out
    fna = tmp_path / "one.fna"
    fna.write_text("".join(db["fna"].read_text().splitlines(True)[4:6]))
    trace = tmp_path / "trace"
    out = invoke(p_cli.cli, ["scan", db["dcp"], fna, "--engine", "native",
                             "--device", "cpu", "--profile-dir", trace,
                             "--no-progress"])
    assert f"profiler trace in {trace}" in out
    events = json.loads((trace / "scan_trace.json").read_text())
    assert events["traceEvents"]
    assert members(tmp_path / "one.dcs")
