"""Multi-process scan dry run: N processes in one gloo process group,
their product shards merged, held against one process.

    python -m deciphon_tpu_torch.parallel.multihost_dryrun --nprocs 2 \
        [--device cuda|cpu] [--workload synthetic|pfam] [--out FILE.json]

Runs multihost_worker once alone and then as N processes that join one
gloo process group over TCP on localhost (a free port), each scanning a
contiguous profile shard; checks that the merged products.tsv is
byte-identical to the single process's and that the all-reduced counters
equal its metrics.  Prints one JSON line (the walls of both runs, each
worker's wall to its exit and its scan's seconds, the merge's seconds,
the counters) and exits non-zero when they differ or a worker fails.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_cmd(pid: int, nprocs: int, shared: str, extra: list) -> list:
    return [sys.executable, "-m",
            "deciphon_tpu_torch.parallel.multihost_worker", "--pid",
            str(pid), "--nprocs", str(nprocs), "--shared-dir", shared] + extra


def run_procs(nprocs: int, shared: str, coordinator: str | None,
              extra: list, timeout: float) -> tuple[float, list[float]]:
    """Start the N workers together; returns (wall of all, each worker's
    wall to its exit).  Each worker's output goes to
    `<shared>/worker.<pid>.log`.  A worker that fails or outlasts
    `timeout` ends the run: every worker still running is killed."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if coordinator:
        extra = extra + ["--coordinator", coordinator]
    t0 = time.perf_counter()
    logs = [open(os.path.join(shared, f"worker.{pid}.log"), "wb")
            for pid in range(nprocs)]
    procs = [subprocess.Popen(worker_cmd(pid, nprocs, shared, extra),
                              cwd=ROOT, env=env, stdout=log,
                              stderr=subprocess.STDOUT)
             for pid, log in enumerate(logs)]
    walls: list = [None] * nprocs
    try:
        while None in walls:
            for pid, p in enumerate(procs):
                if walls[pid] is None and p.poll() is not None:
                    walls[pid] = time.perf_counter() - t0
                    if p.returncode != 0:
                        logs[pid].close()
                        with open(logs[pid].name, "rb") as fp:
                            sys.stderr.write(fp.read()[-4000:].decode())
                        raise SystemExit(
                            f"worker {pid} failed rc={p.returncode}")
            if time.perf_counter() - t0 > timeout:
                raise SystemExit(f"workers outlasted {timeout} s")
            time.sleep(0.05)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return time.perf_counter() - t0, walls


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--profiles", type=int, default=5)
    ap.add_argument("--core-size", type=int, default=10)
    ap.add_argument("--seqs", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=120)
    ap.add_argument("--workload", choices=["synthetic", "pfam"],
                    default="synthetic")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each run of workers may take")
    args = ap.parse_args(argv)
    wl = ["--profiles", str(args.profiles), "--core-size",
          str(args.core_size), "--seqs", str(args.seqs), "--seq-len",
          str(args.seq_len), "--workload", args.workload, "--device",
          args.device]

    with tempfile.TemporaryDirectory() as tmp:
        single = os.path.join(tmp, "single")
        multi = os.path.join(tmp, "multi")
        os.makedirs(single)
        os.makedirs(multi)
        t_single, _ = run_procs(1, single, None, wl, args.timeout)
        t_multi, walls = run_procs(args.nprocs, multi,
                                   f"127.0.0.1:{free_port()}", wl,
                                   args.timeout)
        with open(os.path.join(single, "products.tsv")) as fp:
            a = fp.read()
        with open(os.path.join(multi, "products.tsv")) as fp:
            b = fp.read()
        with open(os.path.join(single, "shard.0.meta")) as fp:
            one = json.load(fp)["counters"]
        metas = []
        for pid in range(args.nprocs):
            with open(os.path.join(multi, f"shard.{pid}.meta")) as fp:
                metas.append(json.load(fp))
        with open(os.path.join(multi, "merge.json")) as fp:
            merge = json.load(fp)

    result = {
        "nprocs": args.nprocs,
        "device": args.device,
        "identical_products": a == b,
        "product_lines": a.count("\n") - 1,
        "wall_s_single": t_single,
        "wall_s_multi": t_multi,
        "wall_s_workers": walls,
        "scan_s_workers": [m["scan_s"] for m in metas],
        "merge_s": merge["merge_s"],
        "single_counters": one,
        "global_counters": metas[0]["counters"],
        "counters_agree": all(m["counters"] == one for m in metas),
    }
    result["ok"] = result["identical_products"] and result["counters_agree"]
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(result, fp)
    if not result["ok"]:
        raise SystemExit("products or counters differ between 1 and N "
                         "processes")
    return result


if __name__ == "__main__":
    main()
