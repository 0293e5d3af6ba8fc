"""Graft entry points of the port: a one-card scan step and an n-shard dry
run of the production scan.

Counterpart of the reference's `__graft_entry__.py`:

  * `entry(device)` -> (fn, args): `ops.engine.scan_scores` (the stacked
    lax.scan engine's counterpart, plain PyTorch; no kernel of its own)
    and its seven example tensors on `device`: 2 profiles of K 24 padded
    to lanes of 8, and 2 windows of 48 nt with END-indexed codes;
  * `dryrun_multichip(n, device)`: the full production scan
    (`ScanConfig(engine="kernels-multi")`'s scorer) over
    `make_mesh([device] * n)` (n shards; on one card, n streams of it) and
    on one device, whose products must be byte-identical, with LRT
    survivors so that phase 2 runs.  Its workload is
    `workload.pfam_subset()`: 12 Pfam-shaped profiles and two reads of
    1.2 knt, one carrying a planted domain (the reference presses a local
    HMMER3 file, which a checkout does not hold).

Both run on the card unless the caller passes device="cpu" (the plain
versions of the kernels), as the tests do; without a card, "cuda" raises.

    python -m deciphon_tpu_torch.graft_entry [n]    # n shards, default 2
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch


def _tiny_workload(num_profiles: int, K: int, B: int, L: int):
    """A small (profiles x windows) scan workload: (ProfilePack, xt (B, 13),
    codes (B, L, 5) END-indexed, lengths (B,)), host arrays."""
    from .ops.costs import build_costs
    from .ops.engine import ProfilePack
    from .profile import sample_profile
    from .scan.sequence import frag_codes_ending
    from .xtrans import xtrans_cost_vector

    costs = [build_costs(sample_profile(seed=10 + i, core_size=K))
             for i in range(num_profiles)]
    pack = ProfilePack.from_costs(costs, lane_multiple=8)

    rng = np.random.default_rng(7)
    codes = np.zeros((B, L, 5), dtype=np.int32)
    xt = np.zeros((B, 13), dtype=np.float32)
    lengths = np.full((B,), L, dtype=np.int32)
    for b in range(B):
        seq = rng.integers(0, 4, size=L).astype(np.int8)
        codes[b] = frag_codes_ending(seq)
        xt[b] = xtrans_cost_vector(True, False, L)
    return pack, xt, codes, lengths


def entry(device="cuda"):
    """(fn, example_args): the forward scan step on one device; fn(*args)
    returns (null_costs, alt_costs), both (2, 2) f32."""
    from .ops.engine import scan_scores

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"entry(): device {dev} but no CUDA device is "
                           "available")
    pack, xt, codes, lengths = _tiny_workload(num_profiles=2, K=24, B=2, L=48)
    args = tuple(torch.from_numpy(a).to(dev) for a in (
        pack.core, pack.match, pack.null, pack.background, xt, codes,
        lengths))
    return scan_scores, args


def dryrun_multichip(n_devices: int, device="cuda") -> tuple[str, int]:
    """Run the full production scan over n shards and on one device, check
    byte-identical products and equal survivors above 0 (raising
    RuntimeError otherwise), and return (products.tsv text, survivors)."""
    from .parallel.multidevice import make_mesh
    from .scan.pipeline import ScanConfig, Scanner
    from .scan.scheduler import BucketedPairScorer
    from .workload import pfam_subset

    mesh = make_mesh([device] * n_devices)
    profiles, seqs = pfam_subset()

    def run(devices):
        scanner = Scanner(
            profiles, ScanConfig(device=str(mesh[0]), engine="kernels-multi"),
            scorer=lambda costs: BucketedPairScorer(costs, mesh[0],
                                                    devices=devices))
        with tempfile.TemporaryDirectory() as tmp:
            with open(scanner.run(seqs, os.path.join(tmp, "prod"))) as fp:
                return fp.read(), scanner.metrics.survivors

    multi, surv_multi = run(list(mesh))
    single, surv_single = run([mesh[0]])
    if not surv_multi == surv_single > 0:
        raise RuntimeError("the dry run's workload must exercise phase 2 "
                           f"(LRT survivors {surv_multi}, {surv_single})")
    if multi != single:
        raise RuntimeError("the n-shard products diverged from one device's")
    return multi, surv_multi


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
    print("dryrun ok")
