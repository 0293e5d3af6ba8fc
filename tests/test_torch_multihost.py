"""The port's multi-process scan (deciphon_tpu_torch/parallel/multihost.py)
on the CPU, the cases of tests/test_multihost.py against the port's
module: the shard math and merge, the sentinel race, the supervisor's
re-dispatch and partial merge with port workers (`python -m
deciphon_tpu_torch.parallel.multihost_worker`), a two-process gloo dry
run whose merged products equal one process's, and `_global_counters`
exact past 2^48 through a real two-process all-reduce."""

import json
import os
import socket
import subprocess
import sys

import pytest

from deciphon_tpu_torch.parallel.multihost import (merge_product_shards,
                                                   partition_sizes,
                                                   process_slice,
                                                   supervise_shards,
                                                   wait_for_shards)
from deciphon_tpu_torch.scan.product import HEADER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "deciphon_tpu_torch.parallel.multihost_worker"


def env():
    """The workers' environment: one torch thread each (the plain
    versions run many small ops; test workers share the cores)."""
    e = dict(os.environ, OMP_NUM_THREADS="1")
    e.pop("PYTHONPATH", None)
    return e


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_partition_sizes_balanced():
    # exact reference formula: ceil(max(0, n - i) / k)
    assert partition_sizes(10, 3) == [4, 3, 3]
    assert partition_sizes(2, 4) == [1, 1, 0, 0]
    assert partition_sizes(0, 2) == [0, 0]
    for n in (1, 7, 128, 1000):
        for k in (1, 2, 5, 128):
            sizes = partition_sizes(n, k)
            assert sum(sizes) == n
            assert max(sizes) - min(sizes) <= 1 or 0 in sizes


def test_process_slice_contiguous_cover():
    n, k = 11, 3
    spans = [process_slice(n, k, i) for i in range(k)]
    assert spans[0][0] == 0
    assert spans[-1][1] == n
    for (a, b), (c, d) in zip(spans, spans[1:]):
        assert b == c


def test_merge_product_shards(tmp_path):
    row = ("{seq}\t{win}\t0\t10\t0\t0\t10\t{prof}\tdna\t5.0\t1\t"
           ",B,,;,E,,\n")
    shard0 = tmp_path / "s0"
    shard1 = tmp_path / "s1"
    for d in (shard0, shard1):
        d.mkdir()
    # shard 1 holds the globally first profile: the merge must reorder
    (shard0 / "products.tsv").write_text(
        HEADER + row.format(seq=0, win=0, prof="PB")
        + row.format(seq=1, win=0, prof="PB"))
    (shard1 / "products.tsv").write_text(
        HEADER + row.format(seq=0, win=0, prof="PA"))
    out = merge_product_shards(str(tmp_path), [str(shard0), str(shard1)],
                               ["PA", "PB"])
    lines = open(out).read().splitlines()
    assert [ln.split("\t")[7] for ln in lines[1:]] == ["PA", "PB", "PB"]


def test_wait_for_shards_keeps_sentinel_of_dead_worker(tmp_path):
    """A worker that writes its sentinel and exits between the exists()
    check and the liveness probe still counts as done."""
    shared = str(tmp_path)
    calls = {"n": 0}

    def is_alive(pid):
        if calls["n"] == 0:
            with open(os.path.join(shared, "shard.0.done"), "w"):
                pass
        calls["n"] += 1
        return False

    done, missing = wait_for_shards(shared, 1, timeout_s=2.0,
                                    is_alive=is_alive)
    assert done == [0] and missing == []


def spawn_worker(pid, nprocs, shared, extra):
    cmd = [sys.executable, "-m", WORKER, "--pid", str(pid), "--nprocs",
           str(nprocs), "--shared-dir", str(shared), "--device", "cpu",
           "--profiles", "3", "--core-size", "8", "--seqs", "2",
           "--seq-len", "60", "--no-merge"] + extra
    return subprocess.Popen(cmd, cwd=REPO, env=env(),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def test_supervisor_redispatches_crashed_shard(tmp_path):
    """A worker killed mid-run is started again and its shard completes."""
    marker = tmp_path / "crashed.once"

    def spawn(pid):
        extra = ["--crash-marker", str(marker)] if pid == 1 else []
        return spawn_worker(pid, 2, tmp_path, extra)

    report = supervise_shards(str(tmp_path), 2, spawn, max_retries=1,
                              timeout_s=300)
    assert report["failed"] == []
    assert report["done"] == [0, 1]
    assert report["restarts"] == {1: 1}
    assert marker.exists()  # the crash really happened
    for pid in (0, 1):
        assert (tmp_path / f"shard.{pid}.done").exists()
        assert (tmp_path / f"shard.{pid}" / "products.tsv").exists()


def test_supervisor_partial_merge_on_permanent_failure(tmp_path):
    """A shard that keeps crashing past max_retries is reported failed;
    the surviving shards still merge."""
    def spawn(pid):
        extra = ["--crash-always"] if pid == 1 else []
        return spawn_worker(pid, 2, tmp_path, extra)

    report = supervise_shards(str(tmp_path), 2, spawn, max_retries=1,
                              timeout_s=300)
    assert report["failed"] == [1]
    assert report["done"] == [0]
    assert report["restarts"] == {1: 1}
    failures = json.load(open(tmp_path / "failures.json"))
    assert failures["failed_shards"] == [1]
    out = merge_product_shards(str(tmp_path), [str(tmp_path / "shard.0")],
                               [])
    assert open(out).readline() == HEADER


def test_two_process_dryrun_identical_products(tmp_path):
    """Two processes in a gloo group give one process's products, byte
    for byte, and their all-reduced counters equal its metrics; products
    come from both halves of the database, so the merge reorders."""
    out = tmp_path / "dryrun.json"
    r = subprocess.run(
        [sys.executable, "-m", "deciphon_tpu_torch.parallel.multihost_dryrun",
         "--nprocs", "2", "--device", "cpu", "--profiles", "16",
         "--core-size", "10", "--seqs", "16", "--seq-len", "120",
         "--timeout", "240", "--out", str(out)],
        cwd=REPO, env=env(), capture_output=True, timeout=560)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    result = json.load(open(out))
    assert result["ok"] is True
    assert result["identical_products"] is True
    assert result["counters_agree"] is True
    assert result["product_lines"] >= 2
    assert result["global_counters"]["windows"] == 256


COUNTERS = """
import json, sys
from deciphon_tpu_torch.parallel.multihost import (_global_counters,
                                                   init_multihost)
pid = int(sys.argv[1])
init_multihost(sys.argv[2], 2, pid)
big = (1 << 52) + 12345
out = _global_counters({"cells": big + pid, "max": (1 << 62) - 1 + pid,
                        "zero": 0}, 2)
print(json.dumps(out))
import torch.distributed as dist
dist.destroy_process_group()
"""


def test_global_counters_exact_past_2_48():
    """Two processes all-reduce int64 counters exactly past 2^48 (and up
    to 2^63 - 1); one process is the identity."""
    from deciphon_tpu_torch.parallel.multihost import _global_counters

    big = (1 << 52) + 12345
    assert _global_counters({"cells": big}, 1) == {"cells": big}
    addr = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", COUNTERS, str(pid),
                               addr], cwd=REPO, env=env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=120)
            assert p.returncode == 0, e.decode()[-2000:]
            outs.append(json.loads(o.decode().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    want = {"cells": 2 * big + 1, "max": (1 << 63) - 1, "zero": 0}
    assert outs == [want, want]


@pytest.mark.parametrize("addr", ["127.0.0.1:1234", "tcp://127.0.0.1:1234"])
def test_init_multihost_tcp_method(monkeypatch, addr):
    """init_multihost joins a gloo group at tcp://<coordinator>."""
    import torch.distributed as dist

    from deciphon_tpu_torch.parallel import multihost

    got = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: got.update(backend=backend,
                                                         **kw))
    multihost.init_multihost(addr, 3, 1)
    assert got == {"backend": "gloo", "init_method": "tcp://127.0.0.1:1234",
                   "world_size": 3, "rank": 1}
