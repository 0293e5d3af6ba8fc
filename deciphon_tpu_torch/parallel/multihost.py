"""Multi-process scan: per-process profile shards, merged products.

Counterpart of deciphon_tpu/parallel/multihost.py on torch.distributed.
Each process scans a contiguous shard of the profile database (the
balanced split of c-core/partition_size.c:13-16) with the port's Scanner
and its caller's ScanConfig (its `device` included), writes a product
shard, and process 0 merges the shards back into the reference's
deterministic (profile, sequence, window) order, keyed by the global
profile rank, so the merged products.tsv is process-count-invariant.
Windows never couple different profiles, so the scan itself needs no
traffic between processes.

`init_multihost` joins a gloo process group (torch.distributed, TCP
rendezvous at the coordinator's address); the scalar counters (windows,
cells, survivors, products) are then summed over the processes by an
int64 all-reduce, exact over the whole int64 range.

`partition_sizes`, `process_slice`, `wait_for_shards`,
`_write_failure_report`, `supervise_shards` and `merge_product_shards`
are the port's own copies of the reference's (tests/test_torch_copies.py
holds them equal).
"""

from __future__ import annotations

import json
import os
import time

__all__ = [
    "partition_sizes", "process_slice", "init_multihost",
    "run_sharded_scan", "merge_product_shards", "wait_for_shards",
    "supervise_shards",
]


def partition_sizes(n: int, k: int) -> list[int]:
    """Balanced contiguous partition sizes (c-core/partition_size.c:13-16:
    size_i = ceil(max(0, n - i) / k))."""
    return [(max(0, n - i) + k - 1) // k for i in range(k)]


def process_slice(num_profiles: int, num_processes: int,
                  process_id: int) -> tuple[int, int]:
    """[start, stop) of this process's contiguous profile shard."""
    sizes = partition_sizes(num_profiles, num_processes)
    start = sum(sizes[:process_id])
    return start, start + sizes[process_id]


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int) -> None:
    """Join the gloo process group of `num_processes` processes, as rank
    `process_id`, at `coordinator_address` ("host:port", or a full
    "tcp://host:port" init method; process 0 listens there)."""
    import torch.distributed as dist

    method = (coordinator_address if "://" in coordinator_address
              else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=method,
                            world_size=num_processes, rank=process_id)


def _global_counters(local: dict[str, float],
                     num_processes: int) -> dict[str, float]:
    """Sum integer metrics over the processes of the process group: one
    int64 all-reduce on the CPU (gloo), exact over the whole int64 range
    (a multi-host 'cells' counter can pass 2^48), so no limbs are
    needed."""
    if num_processes <= 1:
        return dict(local)
    import torch
    import torch.distributed as dist

    keys = sorted(local)
    vals = torch.tensor([int(local[k]) for k in keys], dtype=torch.int64)
    dist.all_reduce(vals, op=dist.ReduceOp.SUM)
    return {k: int(v) for k, v in zip(keys, vals.tolist())}


def wait_for_shards(shared_dir: str, num_processes: int,
                    timeout_s: float, is_alive=None,
                    poll_s: float = 0.02) -> tuple[list[int], list[int]]:
    """Wait for shard completion sentinels; returns (done, missing).

    `is_alive(pid) -> bool`, when given, lets the wait give up on a shard
    early once its worker is known dead (instead of burning the full
    timeout) — the failure-detection hook the launcher-side supervisor
    plugs in."""
    deadline = time.monotonic() + timeout_s
    pendings = set(range(num_processes))
    done: list[int] = []
    while pendings:
        for pid in sorted(pendings):
            if os.path.exists(os.path.join(shared_dir,
                                           f"shard.{pid}.done")):
                pendings.discard(pid)
                done.append(pid)
            elif is_alive is not None and not is_alive(pid):
                # Dead worker — but its sentinel is durable and may have
                # landed between the exists() check above and the
                # liveness probe, so re-check before declaring failure
                # (a completed shard must never be dropped from a merge).
                if os.path.exists(os.path.join(shared_dir,
                                               f"shard.{pid}.done")):
                    done.append(pid)
                pendings.discard(pid)
        if not pendings:
            break
        if time.monotonic() > deadline:
            break
        time.sleep(poll_s)
    missing = [p for p in range(num_processes) if p not in done]
    return sorted(done), missing


def _write_failure_report(shared_dir: str, missing: list[int],
                          num_processes: int) -> str:
    """Durable failure record next to the shards (the reference reports
    job failure upstream via JobUpdate.fail, cli/deciphon/worker.py:152;
    here the artifact tier carries the report)."""
    path = os.path.join(shared_dir, "failures.json")
    with open(path, "w") as fp:
        json.dump({"failed_shards": missing,
                   "num_processes": num_processes,
                   "time": time.time()}, fp)
    return path


def run_sharded_scan(profiles, sequences, shared_dir: str, *,
                     process_id: int, num_processes: int,
                     config=None, distributed: bool = False,
                     timeout_s: float = 300.0,
                     allow_partial: bool = False,
                     merge: bool = True) -> str | None:
    """Scan this process's profile shard and merge on process 0.

    Every process calls this with the FULL profile list and sequence
    batch; the function scans only the [start, stop) shard, writes
    `<shared_dir>/shard.<pid>/products.tsv`, signals completion with a
    sentinel file, and process 0 merges all shards into
    `<shared_dir>/products.tsv` once every sentinel exists (the durable
    artifact-granularity coordination the reference uses between workers
    and sched).  `config` is the port's ScanConfig (its `device` where
    the shard scans; "cuda" by default).  The shard's meta file holds its
    scan's seconds (`scan_s`), and process 0 writes the seconds it waited
    for the shards and merged them to `<shared_dir>/merge.json`.  Returns
    the merged path on process 0, None elsewhere.
    """
    from ..scan.pipeline import ScanConfig, Scanner

    start, stop = process_slice(len(profiles), num_processes, process_id)
    shard_dir = os.path.join(shared_dir, f"shard.{process_id}")
    t0 = time.perf_counter()
    scanner = Scanner(list(profiles[start:stop]), config or ScanConfig())
    scanner.run(list(sequences), shard_dir)
    scan_s = time.perf_counter() - t0

    local = {
        "windows": scanner.metrics.windows_scored,
        "cells": scanner.metrics.cells,
        "survivors": scanner.metrics.survivors,
        "products": scanner.metrics.products,
    }
    if distributed:
        local = _global_counters(local, num_processes)
    with open(os.path.join(shared_dir, f"shard.{process_id}.meta"),
              "w") as fp:
        json.dump({"start": start, "stop": stop, "counters": local,
                   "scan_s": scan_s}, fp)
    # sentinel written last: the shard is complete and durable
    with open(os.path.join(shared_dir, f"shard.{process_id}.done"), "w"):
        pass

    if process_id != 0 or not merge:
        return None
    t0 = time.perf_counter()
    done, missing = wait_for_shards(shared_dir, num_processes, timeout_s)
    t1 = time.perf_counter()
    if missing:
        _write_failure_report(shared_dir, missing, num_processes)
        if not allow_partial:
            raise TimeoutError(
                f"shards {missing} never completed "
                f"(failure report: {shared_dir}/failures.json)")
    path = merge_product_shards(
        shared_dir,
        [os.path.join(shared_dir, f"shard.{pid}") for pid in done],
        [p.accession for p in profiles])
    with open(os.path.join(shared_dir, "merge.json"), "w") as fp:
        json.dump({"wait_s": t1 - t0, "merge_s": time.perf_counter() - t1},
                  fp)
    return path


def supervise_shards(shared_dir: str, num_processes: int, spawn, *,
                     max_retries: int = 1, timeout_s: float = 600.0,
                     poll_s: float = 0.1) -> dict:
    """Launcher-side shard babysitter: restart crashed workers, then
    report.

    `spawn(pid)` must start the worker for shard `pid` and return an
    object with `poll()` (None while running, else exit code).  A worker
    that exits nonzero — or exits zero without writing its sentinel —
    is re-dispatched up to `max_retries` times (shards are idempotent:
    the shard dir is rewritten and the sentinel is written last, so a
    retry is safe); beyond that the shard is marked failed.  This is the
    TPU-tier analog of the reference CLI worker restarting a crashed
    scanner and reporting failure upstream
    (cli/deciphon/worker.py:166-175).

    Returns {"done": [...], "failed": [...], "restarts": {pid: n}};
    writes failures.json when any shard failed.  The caller merges with
    merge_product_shards over the done shards.
    """
    procs = {pid: spawn(pid) for pid in range(num_processes)}
    retries = {pid: 0 for pid in range(num_processes)}
    deadline = time.monotonic() + timeout_s
    done: set[int] = set()
    failed: set[int] = set()

    def sentinel(pid: int) -> bool:
        return os.path.exists(os.path.join(shared_dir, f"shard.{pid}.done"))

    while len(done) + len(failed) < num_processes:
        for pid, proc in list(procs.items()):
            if pid in done or pid in failed:
                continue
            if sentinel(pid):
                done.add(pid)
                continue
            rc = proc.poll()
            if rc is None:
                continue
            if rc == 0 and sentinel(pid):
                done.add(pid)
            elif retries[pid] < max_retries:
                retries[pid] += 1
                procs[pid] = spawn(pid)
            else:
                failed.add(pid)
        if time.monotonic() > deadline:
            # Kill every straggler BEFORE writing the failure report: an
            # orphaned worker could otherwise write its sentinel after
            # failures.json exists, or race a retry/merge over the same
            # shard dir.
            for pid, proc in procs.items():
                if pid not in done and proc.poll() is None:
                    kill = getattr(proc, "kill", None) or getattr(
                        proc, "terminate", None)
                    if kill is not None:
                        kill()
            failed.update(pid for pid in range(num_processes)
                          if pid not in done)
            break
        time.sleep(poll_s)
    if failed:
        _write_failure_report(shared_dir, sorted(failed), num_processes)
    return {"done": sorted(done), "failed": sorted(failed),
            "restarts": {pid: n for pid, n in retries.items() if n}}


def merge_product_shards(out_dir: str, shard_dirs: list[str],
                         profile_order: list[str]) -> str:
    """Merge per-process product shards (c-core/product.c:34-88 analog).

    Rows are re-keyed by (global profile rank, sequence, window, hit) so
    the merged file is identical to a single-process scan regardless of
    process count.  h3r blob trees are unioned unchanged (their paths
    already carry the global coordinates)."""
    import shutil

    from ..scan.product import HEADER

    rank = {acc: i for i, acc in enumerate(profile_order)}
    rows: list[tuple[tuple, str]] = []
    for sd in shard_dirs:
        tsv = os.path.join(sd, "products.tsv")
        with open(tsv) as fp:
            header = fp.readline()
            assert header == HEADER
            for raw in fp:
                cols = raw.split("\t")
                key = (rank[cols[7]], int(cols[0]), int(cols[1]),
                       int(cols[4]))
                rows.append((key, raw))
        hm = os.path.join(sd, "hmmer")
        if os.path.isdir(hm):
            for root, _, files in os.walk(hm):
                rel = os.path.relpath(root, sd)
                dst = os.path.join(out_dir, rel)
                os.makedirs(dst, exist_ok=True)
                for f in files:
                    shutil.copy2(os.path.join(root, f), os.path.join(dst, f))
    rows.sort(key=lambda kv: kv[0])
    os.makedirs(os.path.join(out_dir, "hmmer"), exist_ok=True)
    path = os.path.join(out_dir, "products.tsv")
    with open(path, "w") as fp:
        fp.write(HEADER)
        for _, raw in rows:
            fp.write(raw)
    return path
