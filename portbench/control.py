"""The control of the comparison, and its lower readings' companion.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 \\
        [--device cuda]

For each seed it draws the cell's database and the first 32 batches of
its stream as a run does, takes the sample of reads that a run checks
(with no program, none of its lines), and scans it with the reference
twice: in float32, as the
comparison does, and in bfloat16, the nearest precision below the
configuration's, put in the program's place.  It prints the comparison's
numbers for the bfloat16 lines, one JSON line a seed: they are the upper
readings from which limits/<cell>.json is set, and each must fail the
limit.  It also prints the reference's wall, which every run pays after
its window.  Benchmark runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


BATCHES = 32  # the stream's first batches, about a window's worth


def control(spec: dict, seed: int, device: str) -> dict:
    import torch

    from . import check, model, traffic as traffic_mod

    cfg, tr = spec["config"], spec["traffic"]
    hmms = model.draw(cfg, cfg["database_seed"])
    served = [traffic_mod.batch(cfg, hmms, tr, seed, j)
              for j in range(BATCHES)]
    # no program, so no program lines: the sampled reads' pairs alone
    triples = check.sample(tr, served, [""] * BATCHES, hmms, seed)
    near: set = set()
    t0 = time.perf_counter()
    ref = check.reference_lines(cfg, hmms, served, triples, device,
                                near=near)
    t1 = time.perf_counter()
    low = check.reference_lines(cfg, hmms, served, triples, device,
                                dtype=torch.bfloat16)
    t2 = time.perf_counter()
    numbers = check.compare(low, ref, near)
    return {"seed": seed, **numbers,
            "fails": not check.judge(numbers, spec["limits"]),
            "reference_s": t1 - t0, "control_s": t2 - t1,
            "pairs": len(triples)}


def main(argv=None) -> int:
    from .run import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    spec = resolve(a.workload)
    for seed in a.seeds:
        print(json.dumps({"workload": a.workload,
                          **control(spec, seed, a.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
