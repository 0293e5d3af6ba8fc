"""One process of the multi-process scan (see multihost_dryrun.py).

    python -m deciphon_tpu_torch.parallel.multihost_worker --pid 0 \
        --nprocs 2 --coordinator 127.0.0.1:29500 --shared-dir DIR

Builds a deterministic workload (the same seeds in every process, so no
input moves between them), joins the gloo process group when given a
coordinator, scans its profile shard on `--device` (the card by default)
and, unless `--no-merge`, merges the product shards on process 0, which
prints the merged path.  Workloads: `synthetic`, seeded `sample_profile`
draws and reads, read i carrying the planted domain of profile i modulo
their count (with 16 profiles of K 10 and 16 reads of 120 nt, products
come from both halves of the database, so the merge orders real lines);
`pfam`, the 200-profile x 8 x 10 knt scan of `workload.pfam_scan()`
(about 10 s to build on a CPU).  `--crash-marker` and `--crash-always`
inject faults for the supervisor's tests.
"""

from __future__ import annotations

import argparse
import os


def workload(args):
    """(profiles, sequences) of the chosen workload."""
    import numpy as np

    from ..profile import sample_profile
    from ..scan.sequence import Sequence
    from ..workload import pfam_scan, planted_read

    if args.workload == "pfam":
        return pfam_scan()
    profiles = [sample_profile(seed=100 + i, core_size=args.core_size)
                for i in range(args.profiles)]
    rng = np.random.default_rng(7)
    reads = [planted_read(rng, profiles[i % len(profiles)], args.seq_len)
             for i in range(args.seqs)]
    return profiles, [Sequence.make(i, f"seq{i}", r)
                      for i, r in enumerate(reads)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the process group's rendezvous")
    ap.add_argument("--shared-dir", required=True)
    ap.add_argument("--profiles", type=int, default=5)
    ap.add_argument("--core-size", type=int, default=10)
    ap.add_argument("--seqs", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=120)
    ap.add_argument("--workload", choices=["synthetic", "pfam"],
                    default="synthetic")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the scan (cuda or cpu)")
    ap.add_argument("--no-merge", action="store_true",
                    help="scan the shard only; a supervisor merges")
    ap.add_argument("--crash-marker", default=None,
                    help="fault injection: die before writing the shard on "
                         "the attempt that creates this marker file "
                         "(absent -> crash)")
    ap.add_argument("--crash-always", action="store_true",
                    help="fault injection: die before scanning, always")
    args = ap.parse_args(argv)

    if args.crash_always:
        os._exit(1)

    from ..scan.pipeline import ScanConfig
    from .multihost import init_multihost, run_sharded_scan

    distributed = args.coordinator is not None and args.nprocs > 1
    if distributed:
        init_multihost(args.coordinator, args.nprocs, args.pid)
    profiles, sequences = workload(args)
    if args.crash_marker and not os.path.exists(args.crash_marker):
        with open(args.crash_marker, "w"):
            pass
        # die with the run under way (modules loaded, workload built) and
        # no shard written: the supervisor must see the nonzero exit with
        # no completion sentinel and dispatch this shard again.  (A timer
        # as in the reference's script would race the scan: importing
        # this package already loads torch and the scheduler.)
        os._exit(1)
    try:
        merged = run_sharded_scan(
            profiles, sequences, args.shared_dir, process_id=args.pid,
            num_processes=args.nprocs,
            config=ScanConfig(device=args.device), distributed=distributed,
            merge=not args.no_merge)
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    if args.pid == 0 and not args.no_merge:
        print(merged, flush=True)


if __name__ == "__main__":
    main()
