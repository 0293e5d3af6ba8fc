"""The port's library layer against the reference's: the python-core
compatibility API (`core.PressContext / Scan / Batch / Sequence`,
mirrored from tests/test_core_api.py), `schema` (tests/test_schema.py)
and the snap archives and their views (tests/test_snap.py), each case run
on both packages' objects; the cases need no reference data.  Products
are compared byte for byte.
"""

import zipfile
from datetime import datetime
from pathlib import Path

import pytest
import torch
from pydantic import ValidationError

import deciphon_tpu.core as r_core
import deciphon_tpu.intervals as r_intervals
import deciphon_tpu.schema as r_schema
import deciphon_tpu.snap.hit as r_hit
import deciphon_tpu.snap.match as r_match
import deciphon_tpu.snap.snap_file as r_snap_file
import deciphon_tpu.snap.view as r_view
import deciphon_tpu_torch.core as p_core
import deciphon_tpu_torch.intervals as p_intervals
import deciphon_tpu_torch.schema as p_schema
import deciphon_tpu_torch.snap.hit as p_hit
import deciphon_tpu_torch.snap.match as p_match
import deciphon_tpu_torch.snap.snap_file as p_snap_file
import deciphon_tpu_torch.snap.view as p_view
from deciphon_tpu_torch.scan.fasta_io import read_fasta
from deciphon_tpu_torch.workload import hmm_text
from test_torch_cli import five_hmms, planted_fasta

torch.set_num_threads(1)

PACKAGES = {"port": (p_core, p_schema, p_snap_file, p_view),
            "ref": (r_core, r_schema, r_snap_file, r_view)}


@pytest.fixture(scope="module")
def pressed(tmp_path_factory):
    """The five profiles pressed through the port's PressContext, and
    the planted reads: (dcp path, [(id, name, data)])."""
    d = tmp_path_factory.mktemp("core")
    (d / "db.hmm").write_text(hmm_text(five_hmms()))
    with p_core.PressContext(str(d / "db.hmm"), str(d / "db.dcp"),
                             gencode_id=1, epsilon=0.01) as ctx:
        assert ctx.nproteins == 5
        for _ in range(ctx.nproteins):
            ctx.next()
    from deciphon_tpu_torch.io.dcp import read_dcp_profiles

    _, profiles = read_dcp_profiles(str(d / "db.dcp"))
    (d / "reads.fna").write_text(planted_fasta(profiles))
    reads = [(i + 1, name.split()[0], seq) for i, (name, seq) in
             enumerate(read_fasta(str(d / "reads.fna")))]
    return d / "db.dcp", reads


def core_scan(pkg: str, dcp: Path, reads, out: Path, **kw):
    core, schema, _, _ = PACKAGES[pkg]
    engine = dict(engine="kernels", device="cpu") if pkg == "port" else \
        dict(engine="jax")
    scan = core.Scan(schema.DBFile(path=dcp), **engine, **kw)
    batch = core.Batch()
    for r in reads:
        batch.add(core.Sequence(*r))
    return scan, batch, schema.NewSnapFile(path=out)


def test_core_press_scan_flow(pressed, tmp_path):
    """PressContext -> Scan.run -> make_archive: the port's snap holds the
    reference's products, byte for byte."""
    dcp, reads = pressed
    tsv = {}
    for pkg in PACKAGES:
        scan, batch, snap = core_scan(pkg, dcp, reads,
                                      tmp_path / f"{pkg}.dcs",
                                      num_threads=2)
        assert len(batch) == len(reads)
        scan.run(snap, batch)
        assert scan.progress() == 100
        snap.make_archive()
        with zipfile.ZipFile(tmp_path / f"{pkg}.dcs") as z:
            tsv[pkg] = z.read(f"{pkg}/products.tsv")
        prods = PACKAGES[pkg][2].read_snap(tmp_path / f"{pkg}.dcs").products
        assert len(prods) >= 2
        batch.reset()
        assert len(batch) == 0
    assert tsv["port"] == tsv["ref"]


def test_core_reuse_scan(pressed, tmp_path):
    """The reference's reuse flow (c-core/test_scan.c:50-78): one Scan,
    one run() per sequence into the same snap dir; each run truncates
    products.tsv, so it holds only the last batch's rows.  Cached and
    uncached runs write the same rows as the reference's, and uncached
    runs release the scorer between runs."""
    dcp, reads = pressed
    reads = [r for r in reads if r[1] in ("r0", "r1")]
    rows = {}
    for pkg in PACKAGES:
        for cache in (True, False):
            scan, batch, snap = core_scan(
                pkg, dcp, [], tmp_path / f"{pkg}_{cache}" / "result.dcs",
                cache=cache)
            got = []
            for r in reads:
                batch.add(PACKAGES[pkg][0].Sequence(*r))
                scan.run(snap, batch)
                assert scan.progress() == 100
                tsv = (snap.basedir / "products.tsv").read_text()
                lines = [ln for ln in tsv.splitlines()[1:] if ln]
                assert lines and {int(ln.split("\t")[0]) for ln in lines} \
                    == {r[0]}
                got.append(lines)
                batch.reset()
            assert (scan._scanner.scorer is None) == (not cache)
            rows[(pkg, cache)] = got
    assert rows[("port", True)] == rows[("port", False)] \
        == rows[("ref", True)] == rows[("ref", False)]


def test_core_bad_database(tmp_path):
    bad = tmp_path / "junk.dcp"
    bad.write_bytes(b"not a database")
    with pytest.raises(p_core.DeciphonError, match="cannot open"):
        p_core.Scan(p_schema.DBFile(path=bad), device="cpu")
    with pytest.raises(r_core.DeciphonError, match="cannot open"):
        r_core.Scan(r_schema.DBFile(path=bad), engine="jax")


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("what", ["names", "gencode", "press_request",
                                  "scan_request", "new_snap_file", "job"])
def test_schema(tmp_path, pkg, what):
    """tests/test_schema.py's cases on each package's schema."""
    _, s, snap_file, _ = PACKAGES[pkg]
    if what == "names":
        hmm = s.HMMName(name="minifam.hmm")
        assert hmm.dbname.name == "minifam.dcp"
        assert hmm.dbname.hmmname.name == "minifam.hmm"
        with pytest.raises(ValidationError):
            s.HMMName(name="minifam.dcp")
        with pytest.raises(ValidationError):
            s.DBName(name="x" * 200 + ".dcp")
        s.SnapName(name="result file.dcs")
    elif what == "gencode":
        assert s.Gencode.SGC0 == 1 and s.Gencode.BAPP == 11
        assert str(s.Gencode.CMMC) == "33" and len(s.Gencode) == 27
    elif what == "press_request":
        req = s.PressRequest.create(7, s.HMMName(name="pfam.hmm"),
                                    s.Gencode.SGC0, 0.01)
        assert req.db.name == "pfam.dcp" and req.epsilon == 0.01
        js = req.model_dump_json()
        assert s.PressRequest.model_validate_json(js) == req
        other = p_schema if pkg == "ref" else r_schema
        assert other.PressRequest.model_validate_json(js).model_dump_json() \
            == js
    elif what == "scan_request":
        req = s.ScanRequest(
            id=1, job_id=2, hmm=s.HMMName(name="ab.hmm"),
            db=s.DBName(name="ab.dcp"), multi_hits=True,
            hmmer3_compat=False, seqs=[s.SeqRead(id=1, name="s",
                                                 data="ACGT")])
        again = s.ScanRequest.model_validate_json(req.model_dump_json())
        assert again.seqs[0].data == "ACGT"
    elif what == "new_snap_file":
        nf = s.NewSnapFile(path=tmp_path / "out.dcs")
        basedir = nf.basedir
        basedir.mkdir()
        (basedir / "products.tsv").write_text("sequence\n")
        (basedir / "hmmer").mkdir()
        snap = nf.make_archive()
        assert snap.path.exists() and not basedir.exists()
        assert len(snap_file.read_snap(snap.path).products) == 0
        basedir.mkdir()
        with pytest.raises(ValidationError):
            s.NewSnapFile(path=tmp_path / "out.dcs")
    else:
        j = s.JobRead(id=1, type=s.JobType.scan, state=s.JobState.pend,
                      progress=0, error="", submission=datetime.now())
        assert j.exec_started is None


MATCH_RAW = (
    "CC,S,,;GCT,N,GCT,A;,B,,;ATG,M1,ATG,M;GGT,M2,GGT,G;AT,I2,ATA,I;"
    ",D3,,;,E,,;TAA,C,TAA,*;,T,,"
)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_snap_matches_hits_intervals(pkg):
    """tests/test_snap.py's parsing cases on each package's objects."""
    iv, match, hit = ((p_intervals, p_match, p_hit) if pkg == "port"
                      else (r_intervals, r_match, r_hit))
    py = iv.PyInterval(start=3, stop=10)
    assert py.r == iv.RInterval(start=4, stop=10) and py.r.py == py
    assert py.slice == slice(3, 10)
    assert py.offset(5) == iv.PyInterval(start=8, stop=15)
    with pytest.raises(ValidationError):
        iv.PyInterval(start=5, stop=3)
    ml = match.MatchList.from_string(MATCH_RAW)
    assert len(ml) == 10 and ml[0].state == "S" and ml[0].is_mute
    m = ml[3]
    assert (m.query, m.state, m.amino) == ("ATG", "M1", "M")
    assert m.is_match_state and m.is_core_state
    assert ml.amino == "AMGI*" and ml.query == "CCGCTATGGGTATTAA"
    assert ml[5].is_insert_state and ml[6].is_delete_state
    hits = hit.hits_of(ml)
    assert len(hits) == 1
    assert (hits[0].match_interval.start, hits[0].match_interval.stop) == \
        (3, 7)
    got = hit.QueryIntervalBuilder(ml, offset=100).make(
        hits[0].match_interval)
    assert (got.start, got.stop) == (105, 113)


def test_snap_archive_views(pressed, tmp_path):
    """A snap of the port's core scan read by both packages: the same
    products, hits, GFF, FASTA, str() and alignment views."""
    dcp, reads = pressed
    scan, batch, snap = core_scan("port", dcp, reads, tmp_path / "s.dcs")
    scan.run(snap, batch)
    snap.make_archive()
    views = {}
    for pkg, (_, _, snap_file, view) in PACKAGES.items():
        sf = snap_file.read_snap(tmp_path / "s.dcs")
        prods = sf.products
        assert len(prods) >= 2
        for p in prods:
            assert p.match_list.query
            assert p.window_interval.stop > p.window_interval.start
            assert p.hits
            for h in p.hits:
                assert h.interval.stop > h.interval.start >= \
                    p.window_interval.start
        gff = prods.gff_list().format()
        assert gff.startswith("##gff-version 3") and "ID=1" in gff
        views[pkg] = (str(sf), gff, prods.fasta_list("amino").format(),
                      prods.fasta_list("codon").format(),
                      view.view_alignments(prods),
                      [(h.interval.start, h.interval.stop) for p in prods
                       for h in p.hits])
        assert views[pkg][0].startswith("shape: (")
        assert "state" in views[pkg][4] and "amino" in views[pkg][4]
    assert views["port"] == views["ref"]
