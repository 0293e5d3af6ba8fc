"""The port's services tier against the reference's: the scheduler
(`sched/`), its client (`poster.py`), the worker (`worker_daemon.py`),
the operator CLI (`control.py`), `errors.py` and the deployment files.

One scheduler of each package runs on port 0 with a worker of each: the
reference's `WorkerLoop(engine="jax")`, the port's `WorkerLoop(engine=...,
device="cpu")`, and crossed cases (the port's client and worker against
the reference's scheduler, and the reverse), which show that the wire is
unchanged.  The same press and scan jobs must give the same `.dcp` bytes,
byte-identical snap `products.tsv`, the same JSON of the REST views (job
timestamps aside: only whether each is set), the same snap views, and the
same status code and body for each refusal.

Data: three amino profiles (`peaked_hmm` K 9 and 95, `sample_hmm` K 50)
written with `workload.hmm_text`, and reads planted from the pressed
profiles with a seed.
"""

import json
import os
import re
import subprocess
import sys
import threading
import zipfile
from io import BytesIO
from pathlib import Path

import numpy as np
import pytest
import requests
import torch
import yaml

import deciphon_tpu.alphabet as r_alphabet
import deciphon_tpu.errors as r_errors
import deciphon_tpu.hmmer.client as r_client
import deciphon_tpu.hmmfile as r_hmmfile
import deciphon_tpu.io.dcp as r_dcp
import deciphon_tpu.poster as r_poster
import deciphon_tpu.sched as r_sched
import deciphon_tpu.sched.database as r_database
import deciphon_tpu.worker.progressor as r_progressor
import deciphon_tpu.worker_daemon as r_wd
import deciphon_tpu_torch.alphabet as p_alphabet
import deciphon_tpu_torch.errors as p_errors
import deciphon_tpu_torch.hmmer.client as p_client
import deciphon_tpu_torch.hmmfile as p_hmmfile
import deciphon_tpu_torch.io.dcp as p_dcp
import deciphon_tpu_torch.poster as p_poster
import deciphon_tpu_torch.sched as p_sched
import deciphon_tpu_torch.sched.database as p_database
import deciphon_tpu_torch.worker.progressor as p_progressor
import deciphon_tpu_torch.worker_daemon as p_wd
from deciphon_tpu_torch.press import press
from deciphon_tpu_torch.workload import (hmm_text, peaked_hmm, planted_read,
                                         random_bases, sample_hmm)

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = dict(sched=p_sched, poster=p_poster, wd=p_wd)
REF = dict(sched=r_sched, poster=r_poster, wd=r_wd)
VIEWS = ("prods", "gff", "queries", "states", "codons", "aminos", "view")
STAMPS = ("submission", "exec_started", "exec_ended")
STAMP = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?Z?")
DEADLINE = 120.0  # seconds a claimed job may take on the CPU


def three_hmms():
    """Amino profiles K 9, 50 and 95: the peaked ones confirm,
    sample_hmm's never does."""
    return [peaked_hmm(40, 9), sample_hmm(41, 50)[0], peaked_hmm(42, 95)]


def planted_seqs(dcp) -> list[dict]:
    """Reads carrying the whole of profile 2 (K 95) and of profile 0 (K
    9), and a random read, as the scheduler takes them."""
    _, profiles = p_dcp.read_dcp_profiles(str(dcp))
    rng = np.random.default_rng(5)
    reads = [planted_read(rng, profiles[2], 400, noise=0.01),
             planted_read(rng, profiles[0], 200, noise=0.01),
             random_bases(rng, 300)]
    return [{"name": f"r{i}", "data": r} for i, r in enumerate(reads)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{"dir", "hmm", "dcp", "seqs"}: the profiles as HMMER3 text, pressed
    once (to plant the reads), and the reads."""
    d = tmp_path_factory.mktemp("svc")
    (d / "db.hmm").write_text(hmm_text(three_hmms()))
    press(str(d / "db.hmm"), str(d / "db.dcp"), 1, 0.01)
    return dict(dir=d, hmm=d / "db.hmm", dcp=d / "db.dcp",
                seqs=planted_seqs(d / "db.dcp"))


def unstamped(obj):
    """JSON with each job's timestamps replaced by whether it is set."""
    if isinstance(obj, dict):
        return {k: (v is not None) if k in STAMPS else unstamped(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [unstamped(v) for v in obj]
    return obj


def snap_products(blob: bytes) -> bytes:
    """products.tsv of a snap archive's bytes."""
    with zipfile.ZipFile(BytesIO(blob)) as z:
        (name,) = [n for n in z.namelist() if n.endswith("/products.tsv")]
        return z.read(name)


def answer(r) -> tuple:
    """(status, body) of a reply, its body as JSON where it is JSON."""
    try:
        return r.status_code, r.json()
    except ValueError:
        return r.status_code, r.text


def refusals(url: str, scan_id: int, done_job: int) -> dict:
    """The scheduler's answers to what it must refuse: rejected job state
    transitions, unknown entities, a garbage snap, an hmm or db that was
    never uploaded, a malformed body."""
    t = 30
    return {
        "done->run": answer(requests.patch(
            f"{url}/jobs/{done_job}", json={"state": "run", "progress": 10},
            timeout=t)),
        "done->fail": answer(requests.patch(
            f"{url}/jobs/{done_job}", json={"state": "fail", "error": "x"},
            timeout=t)),
        "no such state": answer(requests.patch(
            f"{url}/jobs/{done_job}", json={"state": "later"}, timeout=t)),
        "unknown db": answer(requests.post(
            f"{url}/scans/", json={"db_id": 99999, "multi_hits": True,
                                   "hmmer3_compat": False,
                                   "seqs": [{"name": "s", "data": "ACGT"}]},
            timeout=t)),
        "unknown job": answer(requests.get(f"{url}/jobs/99999", timeout=t)),
        "unknown scan": answer(requests.get(f"{url}/scans/99999", timeout=t)),
        "garbage snap": answer(requests.post(
            f"{url}/scans/{scan_id}/snap.dcs", data=b"not a zip",
            timeout=t)),
        "hmm not uploaded": answer(requests.post(
            f"{url}/hmms/", json={"name": "none.hmm", "gencode": 1},
            timeout=t)),
        "db not uploaded": answer(requests.post(
            f"{url}/dbs/", json={"name": "none.dcp"}, timeout=t)),
        "bad hmm name": answer(requests.post(
            f"{url}/hmms/", json={"name": "x.txt", "gencode": 1},
            timeout=t)),
        "no endpoint": answer(requests.get(f"{url}/nowhere", timeout=t)),
    }


def flow(sched_mod, client: dict, worker_kw: dict, data, tmp: Path) -> dict:
    """A press job and a scan job on a fresh scheduler of `sched_mod`, run
    by `client`'s Poster and WorkerLoop; returns what the services give
    back: the .dcp and snap products as downloaded, the REST views, the
    snap views and the refusals."""
    settings = sched_mod.SchedSettings(host="127.0.0.1", port=0,
                                       data_dir=str(tmp / "sched"))
    with sched_mod.SchedServer(settings) as server:
        poster = client["poster"].Poster(server.url)
        assert poster.handshake() == {"status": "ok"}
        loop = client["wd"].WorkerLoop(poster, workdir=str(tmp / "work"),
                                       **worker_kw)
        poster.upload("hmms", str(data["hmm"]))
        hmm = poster.hmm_post("db.hmm", gencode=1, epsilon=0.01)
        assert hmm["job"]["state"] == "pend"
        assert loop.poll_once(timeout=0)
        db_id = poster.db_list()[0]["id"]
        scan = poster.scan_post(db_id, data["seqs"])
        assert scan["job"]["state"] == "pend"
        assert loop.poll_once(timeout=0)
        assert not loop.poll_once(timeout=0)  # the queue is empty
        poster.download("dbs", "db.dcp", str(tmp / "fetched.dcp"))
        paths = ["/", "/health", "/jobs", "/hmms", "/dbs", "/scans", "/seqs",
                 f"/jobs/{hmm['job']['id']}", f"/jobs/{scan['job']['id']}",
                 f"/hmms/{hmm['id']}", f"/dbs/{db_id}", f"/scans/{scan['id']}",
                 f"/scans?job_id={scan['job']['id']}", "/seqs/1"]
        out = dict(
            dcp=(tmp / "fetched.dcp").read_bytes(),
            products=snap_products(poster.snap_get(scan["id"])),
            posted=unstamped([hmm, scan]),
            rest={p: unstamped(requests.get(server.url + p,
                                            timeout=30).json())
                  for p in paths},
            views={k: poster.snap_view(scan["id"], k) for k in VIEWS},
            refusals=refusals(server.url, scan["id"], hmm["job"]["id"]))
    return out


@pytest.fixture(scope="module")
def ref_flow(data, tmp_path_factory):
    """The reference's scheduler, client and worker (engine="jax")."""
    return flow(r_sched, REF, dict(engine="jax"), data,
                tmp_path_factory.mktemp("ref_flow"))


FLOWS = {
    "kernels": (p_sched, PORT, dict(engine="kernels", device="cpu")),
    "torch": (p_sched, PORT, dict(engine="torch", device="cpu")),
    "native": (p_sched, PORT, dict(engine="native", device="cpu")),
    "port client on reference sched": (r_sched, PORT,
                                       dict(engine="kernels", device="cpu")),
    "reference client on port sched": (p_sched, REF, dict(engine="jax")),
}


@pytest.mark.parametrize("case", list(FLOWS))
def test_sched_and_worker_match_reference(data, ref_flow, tmp_path, case):
    """Press and scan jobs through a scheduler and a worker give the
    reference's .dcp bytes, products.tsv bytes, REST and snap views and
    refusals."""
    sched_mod, client, worker_kw = FLOWS[case]
    got = flow(sched_mod, client, worker_kw, data, tmp_path)
    want = ref_flow
    assert got["dcp"] == want["dcp"] == data["dcp"].read_bytes()
    assert got["products"] == want["products"]
    rows = got["products"].decode().splitlines()[1:]
    assert {r.split("\t")[7] for r in rows} == {"PEAKED40", "PEAKED42"}
    assert got["posted"] == want["posted"]
    for path, body in want["rest"].items():
        assert got["rest"][path] == body, path
    jobs = got["rest"]["/jobs"]
    assert [(j["type"], j["state"], j["progress"]) for j in jobs] == [
        ("hmm", "done", 100), ("scan", "done", 100)]
    assert got["views"] == want["views"]
    assert "PEAKED42" in got["views"]["view"]
    assert got["refusals"] == want["refusals"]
    assert [s for s, _ in got["refusals"].values()] == [
        403, 403, 422, 404, 404, 404, 422, 412, 412, 422, 404]


def ctl(package: str, home: Path, *args) -> str:
    """One deciphonctl command of `package` in a process of its own, with
    HOME at `home` (no real configuration is read or written)."""
    env = dict(os.environ, HOME=str(home))
    env.pop("DECIPHONCTL_SCHED_URL", None)
    res = subprocess.run(
        [sys.executable, "-m", f"{package}.control", *map(str, args)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_control_cli_matches_reference(data, tmp_path):
    """deciphonctl of the port against the port's scheduler prints what the
    reference's prints against the reference's, job timestamps and the
    configuration's path aside: config set-url/show, hmm add/ls, db ls,
    job ls, scan post/ls, seq ls, snap get and its views.  The port keeps
    its configuration under ~/.config/deciphon_tpu_torch/."""
    outs = {}
    for package, sched_mod, client, worker_kw in (
            ("deciphon_tpu_torch", p_sched, PORT,
             dict(engine="kernels", device="cpu")),
            ("deciphon_tpu", r_sched, REF, dict(engine="jax"))):
        tmp = tmp_path / package
        home = tmp / "home"
        settings = sched_mod.SchedSettings(host="127.0.0.1", port=0,
                                           data_dir=str(tmp / "sched"))
        with sched_mod.SchedServer(settings) as server:
            loop = client["wd"].WorkerLoop(client["poster"].Poster(
                server.url), workdir=str(tmp / "work"), **worker_kw)
            c = lambda *a: ctl(package, home, *a)  # noqa: E731
            conf = home / ".config" / package / "deciphonctl.json"
            out = [c("config", "set-url", server.url)]
            assert out[0] == f"saved {conf}\n"
            assert json.loads(conf.read_text()) == {"sched_url": server.url}
            out[0] = "saved CONFIG\n"
            assert c("config", "show") == server.url + "\n"
            (tmp / "reads.fna").write_text("".join(
                f">{s['name']} planted\n{s['data']}\n"
                for s in data["seqs"]))
            out.append(c("hmm", "add", data["hmm"]))
            assert loop.poll_once(timeout=0)
            out += [c("hmm", "ls"), c("db", "ls"),
                    c("scan", "post", 1, tmp / "reads.fna")]
            assert loop.poll_once(timeout=0)
            out += [c("job", "ls"), c("job", "get", 2), c("scan", "ls"),
                    c("seq", "ls")]
            dest = tmp / "got.dcs"
            assert c("snap", "get", 1, dest) == f"wrote {dest}\n"
            out.append(snap_products(dest.read_bytes()).decode())
            out += [c("snap", k, 1) for k in VIEWS]
        outs[package] = [STAMP.sub("T", o) for o in out]
    got, want = outs["deciphon_tpu_torch"], outs["deciphon_tpu"]
    assert got == want
    assert "PEAKED42" in got[-1] and '"state": "done"' in got[5]


def test_queue_claims_are_disjoint(tmp_path):
    """Workers long-polling the port's queue at once never claim one job
    twice and lose none: more threads than cores, the switch interval
    shortened."""
    settings = p_sched.SchedSettings(host="127.0.0.1", port=0,
                                     data_dir=str(tmp_path))
    n = 60
    with p_sched.SchedServer(settings) as server:
        for i in range(n):
            server.database.queue_publish("t-claims", json.dumps({"n": i}))
        got, lock = [], threading.Lock()

        def worker():
            local = p_poster.Poster(server.url)
            while True:
                msg = local.queue_next("t-claims", timeout=0)
                if msg is None:
                    return
                with lock:
                    got.append(msg["n"])

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            ts = [threading.Thread(target=worker)
                  for _ in range(2 * (os.cpu_count() or 4))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=DEADLINE)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in ts)
    assert sorted(got) == list(range(n))


def test_worker_reports_failed_jobs(data, tmp_path):
    """A press job of a file that holds no profile and a scan job whose
    database cannot be read end `fail`, each with the error the
    reference's worker reports; the worker goes on to the next job."""
    errors = {}
    for name, client, worker_kw in (
            ("port", PORT, dict(engine="kernels", device="cpu")),
            ("ref", REF, dict(engine="jax"))):
        tmp = tmp_path / name
        tmp.mkdir()
        settings = client["sched"].SchedSettings(
            host="127.0.0.1", port=0, data_dir=str(tmp / "sched"))
        with client["sched"].SchedServer(settings) as server:
            poster = client["poster"].Poster(server.url)
            loop = client["wd"].WorkerLoop(poster, workdir=str(tmp / "w"),
                                           **worker_kw)
            (tmp / "bad.hmm").write_text("not a profile\n")
            (tmp / "bad.dcp").write_bytes(b"not a database")
            poster.upload("hmms", str(tmp / "bad.hmm"))
            hmm = poster.hmm_post("bad.hmm", gencode=1)
            assert loop.poll_once(timeout=0)
            poster.upload("dbs", str(tmp / "bad.dcp"))
            db = poster.db_post("bad.dcp")
            scan = poster.scan_post(db["id"], data["seqs"][:1])
            assert loop.poll_once(timeout=0)
            jobs = [poster.job_get(j["job"]["id"]) for j in (hmm, scan)]
            assert [j["state"] for j in jobs] == ["fail", "fail"]
            errors[name] = [j["error"].replace(str(tmp), "TMP")
                            for j in jobs]
            assert not loop.poll_once(timeout=0)
    assert errors["port"] == errors["ref"]
    assert "no HMMER3/f profiles found" in errors["port"][0]


def test_cli_worker_help_and_no_card(data, tmp_path):
    """`cli worker --help` lists --device and the port's engines; without a card, `worker --device cuda` exits non-zero with the
    "no CUDA device" message before it claims a job: the scheduler's queue
    keeps the job."""
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "deciphon_tpu_torch.cli", "worker", *a],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    res = run("--help")
    assert res.returncode == 0, res.stderr
    for text in ("--device", "[cuda|cpu]", "--confirm", "--workdir",
                 "[kernels|kernels-multi|torch|native]"):
        assert text in res.stdout, text
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the worker would run")
    settings = p_sched.SchedSettings(host="127.0.0.1", port=0,
                                     data_dir=str(tmp_path / "sched"))
    with p_sched.SchedServer(settings) as server:
        poster = p_poster.Poster(server.url)
        poster.upload("hmms", str(data["hmm"]))
        hmm = poster.hmm_post("db.hmm", gencode=1)
        for args in ((), ("--device", "cuda")):
            res = run("--sched", server.url, "--workdir",
                      str(tmp_path / "w"), *args)
            assert res.returncode != 0
            assert "--device cuda" in res.stderr
            assert "no CUDA device" in res.stderr
            assert "consuming" not in res.stdout
        assert poster.job_get(hmm["job"]["id"])["state"] == "pend"
        msg = poster.queue_next("press", timeout=0)
        assert msg["job_id"] == hmm["job"]["id"]


# the port's exceptions and their counterparts in the reference
ERRORS = [
    (p_hmmfile.HMMFileError("x"), r_hmmfile.HMMFileError("x")),
    (p_dcp.DcpFormatError("x"), r_dcp.DcpFormatError("x")),
    (p_alphabet.InvalidSequenceError("x"),
     r_alphabet.InvalidSequenceError("x")),
    (p_alphabet.MixedTUError("x"), r_alphabet.MixedTUError("x")),
    (p_client.HMMERError("x"), r_client.HMMERError("x")),
    (p_progressor.Interrupted("x"), r_progressor.Interrupted("x")),
    (p_database.NotFoundError("x"), r_database.NotFoundError("x")),
    (p_database.JobStateTransitionError("done", "run"),
     r_database.JobStateTransitionError("done", "run")),
    (p_errors.DeciphonTPUError("x"), r_errors.DeciphonTPUError("x")),
    (ValueError("x"), ValueError("x")),
    (FileNotFoundError("x"), FileNotFoundError("x")),
    (KeyError("x"), KeyError("x")),
]


@pytest.mark.parametrize("pair", ERRORS, ids=lambda p: type(p[0]).__name__)
def test_error_codes_match_reference(pair):
    """errors.py maps each exception of the port to the code (and the
    family name) the reference maps its counterpart to."""
    got, want = pair
    assert type(got).__module__.split(".")[0] in ("deciphon_tpu_torch",
                                                  "builtins")
    code = r_errors.error_code(want)
    assert p_errors.error_code(got) == code
    assert p_errors.error_string(code) == r_errors.error_string(code)
    assert p_errors.wrap(got) == r_errors.wrap(want)
    if isinstance(got, ValueError) and not isinstance(got, KeyError):
        assert code != 1  # a known family, not "unknown error"


def test_error_strings_match_reference():
    for code in range(-1, 60):
        assert p_errors.error_string(code) == r_errors.error_string(code)


def compose_commands() -> list[list[str]]:
    with open(ROOT / "deploy" / "torch" / "compose.yml") as fp:
        services = yaml.safe_load(fp)["services"]
    return [s["command"] for s in services.values()]


@pytest.mark.parametrize("command", compose_commands(),
                         ids=lambda c: " ".join(c[:2]))
def test_deploy_commands_name_port_modules(command):
    """Each service of deploy/torch/compose.yml runs a module of the port
    (the image's entry point is `python -m`) whose --help exits 0."""
    module, *args = command
    assert module.split(".")[0] == "deciphon_tpu_torch"
    sub = [a for a in args if not a.startswith("-")][:1]
    if module.endswith(".cli"):
        assert sub == ["worker"]
    res = subprocess.run([sys.executable, "-m", module, *sub, "--help"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "Usage" in res.stdout
    for opt in (a for a in args if a.startswith("--")):
        assert opt in res.stdout, opt
