"""BENCHMARK.json against the contract's form, and every name it holds
against the files that the harness finds by it."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"
MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_form(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    if metric in MAN["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_one_reported_metric(metric):
    """Each per-layer metric moves one end-to-end metric, and that metric
    is reported in each cell that reads the per-layer one."""
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert metric["moves"] in e2e
    cells = metric.get("workloads", [w["name"] for w in MAN["workloads"]])
    moved = e2e[metric["moves"]]
    for c in cells:
        assert c in moved.get("workloads", [c])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    """Each cell's configuration, traffic and limits are files of their
    own; it reports setup_s, another end-to-end metric and a per-layer
    one."""
    cfg = next(c for c in MAN["configs"] if c["name"] == cell["config"])
    assert (REPO / cfg["file"]).is_file()
    assert cfg["file"].startswith("portbench/")
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
    limits = json.loads((BENCH / "limits" / f"{cell['name']}.json")
                        .read_text())
    assert set(limits) == {"lrt_gap", "lines_differing"}
    assert cell["chips"] in (1, 4)
    mine = [m["name"] for m in METRICS
            if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in mine
    assert any(m["name"] in mine and m["name"] != "setup_s"
               for m in MAN["end_to_end"])
    assert any(m["name"] in mine for m in MAN["per_layer"])


def test_configs_used_and_files_distinct():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


def test_config_reduced_matches_file():
    for c in MAN["configs"]:
        body = json.loads((REPO / c["file"]).read_text())
        assert sorted(body["reduced"]) == sorted(c["reduced"])
