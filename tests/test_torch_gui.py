"""The port's GUI controller (the display-free core of `gui.py`) against
the reference's: press with its progress, then scans of pasted text, as
FASTA and as raw lines, give the reference's view text.

Data as tests/test_torch_services.py: three amino profiles as HMMER3
text and reads planted from the pressed profiles.
"""

from pathlib import Path

import pytest
import torch

import deciphon_tpu.gui as r_gui
import deciphon_tpu_torch.gui as p_gui
from test_torch_services import data  # noqa: F401

torch.set_num_threads(1)


def drive(ctl, data, tmp: Path) -> list:
    """Press the profiles, then scan the reads as FASTA, as raw lines and
    a read with no hit; returns the .dcp bytes and the view texts."""
    seen = []
    try:
        dcp = ctl.press(str(data["hmm"]), progress=seen.append)
        assert Path(dcp).parent == tmp and seen[-1] == 100
        assert seen == sorted(seen)
        fasta = "".join(f">{s['name']} planted\n{s['data']}\n"
                        for s in data["seqs"])
        raw = "\n".join(s["data"] for s in data["seqs"][:2])
        progress = []
        views = [ctl.scan_text(fasta, progress=progress.append),
                 ctl.scan_text(raw), ctl.scan_text(data["seqs"][2]["data"])]
        assert progress[-1] == 100
    finally:
        ctl.close()
    return [Path(dcp).read_bytes()] + views


def test_gui_controller_matches_reference(data, tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    got = drive(p_gui.GuiController(workdir=str(tmp_path / "p"),
                                    device="cpu"), data, tmp_path / "p")
    want = drive(r_gui.GuiController(workdir=str(tmp_path / "r"),
                                     engine="jax"), data, tmp_path / "r")
    assert got == want
    assert got[0] == data["dcp"].read_bytes()
    assert "PEAKED42" in got[1] and "amino" in got[1] and "state" in got[1]
    assert "PEAKED42" in got[2] and "PEAKED40" in got[2]
    assert got[3] == "(no hits)"


@pytest.mark.parametrize("engine", ["kernels", "torch"])
def test_gui_controller_passes_engine_and_device(data, tmp_path,
                                                 monkeypatch, engine):
    """The controller builds its scanner daemon with its engine and
    device; the default device is the card."""
    seen = {}

    def launch(dcp, multi_hits, hmmer3_compat, engine, device):
        seen.update(engine=engine, device=device)
        raise RuntimeError("stop")

    import deciphon_tpu_torch.worker as p_worker

    monkeypatch.setattr(p_worker, "launch_scanner", launch)
    assert p_gui.GuiController(workdir=str(tmp_path)).device == "cuda"
    ctl = p_gui.GuiController(workdir=str(tmp_path), engine=engine,
                              device="cpu")
    ctl.dcp_path = str(data["dcp"])
    with pytest.raises(RuntimeError, match="stop"):
        ctl.scan_text("ACGT")
    assert seen == dict(engine=engine, device="cpu")
