"""The port imports no jax and nothing of deciphon_tpu, and its kernel
build is well-formed on hosts without a CUDA toolkit."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import deciphon_tpu_torch
from deciphon_tpu_torch import _build

ROOT = Path(__file__).resolve().parent.parent


def port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        deciphon_tpu_torch.__path__, "deciphon_tpu_torch."))


def foreign(*packages) -> str:
    """Code asserting that no module of `packages` is loaded."""
    return ("import sys\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{packages!r})\n"
            "assert not bad, bad\n")


# no module of these packages may be loaded by the port (msgpack may: the
# h3r blobs of hmmer/h3result.py are msgpack; pydantic may: schema.py and
# intervals.py are pydantic models; requests may: poster.py is the
# scheduler's HTTP client); click only by the command-line modules; no
# module loads tkinter when it is imported (gui.py imports it in run_app)
FOREIGN = foreign("jax", "jaxlib", "deciphon_tpu", "tkinter")
COMMAND_LINE = ["deciphon_tpu_torch.cli", "deciphon_tpu_torch.control"]


@pytest.mark.parametrize("cli", [False, True], ids=["library", "cli"])
def test_port_imports_no_jax(cli):
    """Importing every module of the port but the command-line ones (cli,
    control) loads neither jax, nor deciphon_tpu, nor click,
    nor tkinter; importing those loads no jax, no deciphon_tpu and no
    tkinter."""
    mods = port_modules()
    assert {"deciphon_tpu_torch.ops.viterbi", "deciphon_tpu_torch.scan.pipeline",
            "deciphon_tpu_torch.ops.traceback", "deciphon_tpu_torch._build",
            "deciphon_tpu_torch.scan.scheduler", "deciphon_tpu_torch.convert",
            "deciphon_tpu_torch.profile", "deciphon_tpu_torch.frame",
            "deciphon_tpu_torch.ops.costs", "deciphon_tpu_torch.scan.decoder",
            "deciphon_tpu_torch.workload", "deciphon_tpu_torch.ops.viterbi_torch",
            "deciphon_tpu_torch.ops.engine", "deciphon_tpu_torch.hmmer.forward",
            "deciphon_tpu_torch.hmmer.h3result", "deciphon_tpu_torch.hmmer.wire",
            "deciphon_tpu_torch.hmmer.client",
            "deciphon_tpu_torch.hmmer.daemon", "deciphon_tpu_torch.intervals",
            "deciphon_tpu_torch.schema", "deciphon_tpu_torch.press",
            "deciphon_tpu_torch.io", "deciphon_tpu_torch.io.dcp",
            "deciphon_tpu_torch.scan.fasta_io", "deciphon_tpu_torch.core",
            "deciphon_tpu_torch.native", "deciphon_tpu_torch.snap",
            "deciphon_tpu_torch.snap.match", "deciphon_tpu_torch.snap.fasta",
            "deciphon_tpu_torch.snap.gff", "deciphon_tpu_torch.snap.hit",
            "deciphon_tpu_torch.snap.prod",
            "deciphon_tpu_torch.snap.snap_file",
            "deciphon_tpu_torch.snap.view", "deciphon_tpu_torch.parallel",
            "deciphon_tpu_torch.parallel.multidevice",
            "deciphon_tpu_torch.parallel.multihost",
            "deciphon_tpu_torch.parallel.multihost_worker",
            "deciphon_tpu_torch.parallel.multihost_dryrun",
            "deciphon_tpu_torch.sched", "deciphon_tpu_torch.sched.settings",
            "deciphon_tpu_torch.sched.storage",
            "deciphon_tpu_torch.sched.database",
            "deciphon_tpu_torch.sched.server", "deciphon_tpu_torch.poster",
            "deciphon_tpu_torch.errors", "deciphon_tpu_torch.worker",
            "deciphon_tpu_torch.worker.progressor",
            "deciphon_tpu_torch.worker.daemons", "deciphon_tpu_torch.gui",
            "deciphon_tpu_torch.ops.bruteforce",
            "deciphon_tpu_torch.worker_daemon",
            "deciphon_tpu_torch.graft_entry", *COMMAND_LINE} <= set(mods)
    if cli:
        mods, check = COMMAND_LINE, FOREIGN
    else:
        mods = [m for m in mods if m not in COMMAND_LINE]
        check = foreign("jax", "jaxlib", "deciphon_tpu", "click", "tkinter")
    code = ("import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            + check + "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def imported_names(path: Path, skip: str | None = None) -> set[str]:
    """Every module an `import` or `from` statement of the file names
    (relative imports as ".name"), but those inside its top-level function
    `skip`."""
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.FunctionDef) and n.name == skip)]
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    return names


def port_sources() -> list[Path]:
    pkg = Path(deciphon_tpu_torch.__file__).resolve().parent
    return sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_names_no_foreign_module(path):
    """No import statement of the port, at any depth of any file, names
    jax or deciphon_tpu; only the command-line modules (cli.py, control.py,
    and sched/server.py inside its main()) name click
    (msgpack, which the h3r blobs need, pydantic, which schema.py needs,
    and requests, which poster.py needs, are allowed)."""
    forbidden = ("jax", "jaxlib", "deciphon_tpu")
    rel = path.relative_to(ROOT).as_posix()
    if rel not in {f"deciphon_tpu_torch/{n}" for n in ("cli.py", "control.py")}:
        forbidden += ("click",)
    names = imported_names(path)
    if rel == "deciphon_tpu_torch/sched/server.py":
        # the scheduler's main() is its command line: only there may it
        # import click
        names = {n for n in names if n.split(".")[0] != "click"}
        names |= imported_names(path, skip="main")
    bad = sorted(n for n in names if n.split(".")[0] in forbidden)
    assert not bad, bad


def test_chip_smoke_imports_no_jax():
    """Importing every module chip_smoke.py names loads neither jax nor
    any module of deciphon_tpu."""
    local = sorted(n for n in imported_names(ROOT / "chip_smoke.py")
                   if n.startswith("deciphon_tpu"))
    assert local and all(n.split(".")[0] == "deciphon_tpu_torch"
                         for n in local)
    code = ("import importlib\n"
            f"for m in {local!r}: importlib.import_module(m)\n" + FOREIGN)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a CUDA device, or outside a checkout, the smoke run exits
    non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_find_nvcc_raises_without_toolkit(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("")
    assert _build.find_nvcc() == str(fake)


def test_build_flags_and_source_hash(monkeypatch, tmp_path):
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "-ftz=true" not in flags
    names = {p.name for p in _build.sources()}
    assert names == {"viterbi_score.cu", "viterbi_packed.cu",
                     "viterbi_path.cu", "traceback_walk.cu",
                     "amino_forward.cu"}
    assert set(_build.SIGNATURES) == {
        "dtt_score_pairs", "dtt_score_mixed", "dtt_score_chained",
        "dtt_score_chained_carry", "dtt_score_packed",
        "dtt_score_packed_chained", "dtt_path_pairs", "dtt_score_grid",
        "dtt_walk", "dtt_amino_forward", "dtt_amino_posterior"}
    # every export the wrappers call is bound with argtypes
    exported = "".join(p.read_text() for p in _build.sources())
    for fn, argtypes in _build.SIGNATURES.items():
        assert f'extern "C" int {fn}(' in exported
        params = exported.split(f'extern "C" int {fn}(')[1].split(")")[0]
        assert len(params.split(",")) == len(argtypes), fn
    # the library name follows the sources: an edit means a rebuild
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one")
    monkeypatch.setattr(_build, "CSRC", src)
    before = _build._digest("nvcc")
    (src / "a.cu").write_text("// two")
    assert _build._digest("nvcc") != before
