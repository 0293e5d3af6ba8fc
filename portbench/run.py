"""Run one benchmark cell once on the card and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration
(configs/<name>.json: the profile database) and a traffic mix
(traffic/<name>.json: the batches).  A run:

1. draws the database's HMM parameters from the configuration's
   `database_seed` (model.py; a deployment's database is fixed, as a Pfam
   release is) and presses them with the program's `press_profile`; the
   batches (traffic.py) and the checked sample come from `--seed`;
2. builds `Scanner(profiles, ScanConfig(device="cuda"))` with its
   defaults and warms it up by scanning one batch of the cell's shapes,
   drawn apart from the window's, into a directory of its own;
3. serves a stream of fresh batches in a closed loop with one worker
   until `--seconds` have passed: each batch drawn from the seed, one
   `Scanner.run` into a directory of its own, ending in
   `torch.cuda.synchronize`, the next issued when the last returns (how
   `WorkerLoop` serves a queue of scan jobs);
4. with `--trace 0` reads the cell's end-to-end metrics, with `--trace 1`
   its per-layer metrics from a profiled window (trace.py), each metric
   by its reader metrics/<name>.py;
5. frees the program's state and decides `correct` with the reference
   (check.py), on the card.

The last line of standard output is the JSON result; the compared numbers
and their limits end standard error.  Without a card, or with fewer cards
than the cell asks for, it prints no result and exits with 2.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deciphon_tpu")


def process_age() -> float:
    """Seconds since this process started (its start time in /proc)."""
    try:
        start = int(Path("/proc/self/stat").read_text()
                    .rsplit(")", 1)[1].split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0 + _AGE0


_T0, _AGE0 = time.perf_counter(), 0.0
_AGE0 = process_age()


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


@dataclass
class Run:
    """What a metric reader sees of one run."""

    cell: dict
    config: dict
    traffic: dict
    core_sizes: list
    setup_s: float = 0.0
    window_s: float = 0.0
    peak_bytes: int = 0
    batches: list = field(default_factory=list)  # one dict a batch
    path_windows: list = field(default_factory=list)  # (length, K) a line
    trace: object = None

    @property
    def reads(self) -> int:
        return sum(b["reads"] for b in self.batches)


def read_metric(name: str, run: Run):
    """The metric's value from its reader, metrics/<name>.py `read(run)`;
    None where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


class Stamps:
    """Seconds each stage of a run took, on standard error."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, stage: str) -> None:
        now = time.perf_counter()
        print(f"portbench: {stage} {now - self.t:.3f} s", file=sys.stderr)
        self.t = now


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def resolve(name: str, man: dict | None = None) -> dict:
    """Everything a run of cell `name` reads, found by the names in
    BENCHMARK.json: the cell, its configuration and traffic files, its
    limits and the metrics it reports."""
    from . import check, model, traffic as traffic_mod

    man = man or manifest()
    cell = next(w for w in man["workloads"] if w["name"] == name)
    ccfg = next(c for c in man["configs"] if c["name"] == cell["config"])

    def mine(specs):
        return [m for m in specs if name in m.get("workloads", [name])]

    return {"cell": cell, "config": model.load_config(ccfg["file"]),
            "traffic": traffic_mod.load_traffic(cell["traffic"]),
            "limits": check.load_limits(name),
            "end_to_end": mine(man["end_to_end"]),
            "per_layer": mine(man["per_layer"])}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", hook=None) -> dict:
    """One run of the cell that `spec` (`resolve`) describes; returns the
    result dict.  `hook(scanner)`, if given, may replace parts of the
    scanner after its warm-up (the tests break the timed path with it)."""
    import torch

    from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner
    from deciphon_tpu_torch.scan.sequence import Sequence

    from . import check, model, traffic as traffic_mod, yardstick

    cell, cfg, tr = spec["cell"], spec["config"], spec["traffic"]
    limits = spec["limits"]
    run = Run(cell, cfg, tr, model.core_sizes(cfg))
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    say = Stamps()
    hmms = model.draw(cfg, cfg["database_seed"])
    say("draw")
    profiles = model.press_program(cfg, hmms)
    say("press")

    def seqs_of(batch):
        return [Sequence.make(i, f"r{i}", r) for i, r in enumerate(batch.reads)]

    scanner = Scanner(profiles, ScanConfig(
        device=device, multi_hits=cfg["multi_hits"],
        hmmer3_compat=cfg["hmmer3_compat"]))
    del profiles
    say("scanner")
    served = []
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        warm = traffic_mod.warmup_batch(cfg, hmms, tr, seed)
        scanner.run(seqs_of(warm), os.path.join(tmp, "warmup"))
        sync()
        say("warmup")
        if hook is not None:
            hook(scanner)
        if trace:
            from . import trace as trace_mod

            trace_mod.install_spans(scanner)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        run.setup_s = process_age()

        def window():
            # fresh batches until the window's seconds have passed; drawing
            # a batch (a few ms) is the worker's reading of its job
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                tb = time.perf_counter()
                batch = traffic_mod.batch(cfg, hmms, tr, seed, len(served))
                scanner.run(seqs_of(batch),
                            os.path.join(tmp, f"b{len(served)}"))
                sync()
                served.append(batch)
                lengths = [len(r) for r in batch.reads]
                m = scanner.metrics
                run.batches.append({
                    "reads": len(batch.reads), "nt": batch.nt,
                    "cells": yardstick.batch_cells(run.core_sizes, lengths),
                    "survivors": m.survivors, "walls": dict(m.walls),
                    "wall": time.perf_counter() - tb,
                    "peak": (torch.cuda.max_memory_allocated()
                             if on_card else 0)})
            return time.perf_counter() - t0

        if trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)

            from .trace import WINDOW_SPAN, Trace

            acts = [ProfilerActivity.CPU]
            if on_card:
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                with record_function(WINDOW_SPAN):
                    run.window_s = window()
            run.trace = Trace(prof)
            del prof
        else:
            run.window_s = window()
        if on_card:
            run.peak_bytes = int(torch.cuda.max_memory_allocated())
        products = [check.read_products(os.path.join(tmp, f"b{j}",
                                                     "products.tsv"))
                    for j in range(len(served))]
    say("window")
    print(f"portbench: {len(run.batches)} batches in {run.window_s:.3f} s; "
          f"survivors {[b['survivors'] for b in run.batches]}; walls "
          f"{[round(b['wall'], 3) for b in run.batches]}; peak GiB by "
          f"batch {[round(b['peak'] / 2**30, 4) for b in run.batches]}",
          file=sys.stderr)
    del scanner
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ks = {h.name: h.length for h in hmms}
    run.path_windows = [(ln.window_stop - ln.window_start, ks[ln.profile])
                        for text in products
                        for ln in check.parse_products(text)]

    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    triples = check.sample(tr, served, products, hmms, seed)
    prog = check.program_lines(products, triples, hmms)
    near: set = set()
    ref = check.reference_lines(cfg, hmms, served, triples, device,
                                near=near)
    numbers = check.compare(prog, ref, near)
    say("reference")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": run.peak_bytes}
    out = {"correct": check.judge(numbers, limits),
           "attempted": run.reads, "failed": 0, "metrics": metrics,
           "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["sample"] = {"pairs": len(triples),
                     "reads": len({t[:2] for t in triples}),
                     "lines_program": numbers["lines_program"],
                     "lines_reference": numbers["lines_reference"],
                     "pairs_near": numbers["pairs_near"]}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in check.NUMBERS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch

    cell = next((w for w in manifest()["workloads"]
                 if w["name"] == a.workload), None)
    if cell is None:
        print(f"portbench: no cell {a.workload!r}", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"portbench: {a.workload} needs {cell['chips']} CUDA "
              "device(s); none or too few here", file=sys.stderr)
        return 2
    out = run_cell(resolve(a.workload), a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
