#!/usr/bin/env python3
"""Smoke run of deciphon_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --phases 1-6,12    # these phases and their needs

Phases, each reported on its own lines; any failure exits non-zero.
Without arguments every phase runs; `--phases` names single phases and
ranges in the order below, and the phases they need run with them (5c
needs 4 and 5; 6 needs 4, 5, 5b and 5d; 10 needs 4, 5 and 5b; 8 needs 4;
11 needs 9; 1 and 2 always run).  The ledger scans of phases 4, 5, 5b,
5c, 5d and 10 run one
more scan of a cell on its warm Scanner with DECIPHON_SYNC_DEBUG=1
DECIPHON_FILL_DEBUG=1 (the bucket ledgers of scan/scheduler.py), outside
every counted run and warm median: its products must be the phase's own,
its launches and table uploads those of the counted scan, its ledger one
entry a phase-1 dispatch (a kernel launch; a launch a shard on two
shards) with a wall each, one FILL line a chain or carry launch; each
bucket's wall, true and padded cells, fill and count are printed, with
the share of the scan's wall in the bkt_ walls.

Work beside this process goes to pools of spawned processes (`Side`),
read where a phase needs it.  The card pool (CARD_WORKERS processes on
the card) runs, once the kernels are built, the plain versions of phase
3's B1, B3, B5, B6, B7 and B2 cases (their inputs built there from the
same seeds, held to these by digest; this process runs phase 3's other
plain versions after them) and, once phase 6 has run and timed every
kernel alone, the plain versions of phase 6's score kernels and carry
calls (on copies of the recorded arguments) while this process runs
B2's and the walk's.  The side pool (SIDE_WORKERS processes that never
see the card) builds the profiles of phase 3b and the Pfam and large-K
data once the kernels are built, and from phase 6 on (the scans that
time the host behind) runs the CPU halves of phases 7 and 8 and phase
9's press.  Phase 10's two worker processes start with phase 9, and
phase 7's torch engine, a minute of launch-bound plain PyTorch, runs in
a process of its own on the card beside phase 11 where both run.  Every
helper process runs at a lower CPU priority (nice HELPER_NICE) than this
one, whose work is the critical path.  The checks are the ones this
process would make; times printed with "(side pool)" or "(card pool)"
were taken there.

  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: the kernels of deciphon_tpu_torch/csrc, compiled with nvcc;
  3. each kernel against its plain PyTorch version on the card (for B1,
     B3, B5, B6, B7 and B2 in the card pool), bit for bit, with both
     times, on small cases: B1 score, B3 chain (4 windows
     per slot and an all-pad pair, timed beside B1 on the same windows),
     B5 gang (three profiles interleaved per slot), B8 carry (a 13-block
     window over 4 calls, equal to B1 on the whole window, a normal window
     riding in a spare slot), B4m (the streamed gang: B5's function, on
     B5's kernel up to Kp 2048 and on clusters past it) against the plain
     version at Kp 512, 1024, 5120 and 16896 and against B5 up to 5120,
     B6 packed (two packs, one with a missing segment), B7 packed chain
     (once with the lists every segment shares, once with lists that
     differ per segment), both on PACKED_PLANES with their launch shape,
     CTAs an SM and registers, B2 path and the walk, the walk again on
     `walk_cases` (planted edge cases, an overflow walked again on the
     card, an underflow) at two layouts; the clustered kernels at
     CLUSTER_KPS (2176 to 16896), each with its launch shape (c, w, lpt,
     threads, shared bytes, clusters resident at once): B4 against its
     plain version (8 windows of <= 600 nt, one a pad) and against B1 at
     Kp 1024 and 5120, B2 against its plain version (3 windows of <= 300
     nt, one a pad); the dense grid, B9 (the score body in B4's launch
     shape), against its plain version and against B1 (B4 at Kp 5632) on
     the same (profile, window) pairs at Kp 128, 512, 1024, 2048, 2176 and
     5632 (9 windows of <= 600 nt, a pad and a length-1 window among
     them), with both times per position and B9's launch shape; the mid-K
     band at MIDK_KPS (2176, 3072, 5120): B1, B3, B5 and B8 on clusters
     against their plain versions (card pool), B8's segments against B1
     on the whole window, each with its time per position and launch
     shape;
  3b. the dense grid at full width, through GridScanEngine.scores on
     `bench.py`'s kernel shapes: 8 profiles x 128 windows of 4096 nt at K
     400 and K 1000, 8 x 8 at K 16382; B9's time (median of 3), its GCUPS
     (P*B*L*5*K cells), bound and launch shape, B1 (B4 at K 16382) on the
     same pairs and B9's plain version on the card, all bit-equal;
  4. the Pfam scan, Scanner(ScanConfig(device="cuda")).run, on a
     Pfam-shaped database of 200 random profiles (K geometric over
     50..2000) and 8 reads of 10 knt, four carrying a planted domain,
     through the default route, on which profiles up to K 1022 form packed
     classes and their whole-read windows ride B7: first scan, three warm
     scans (median wall), one under torch.profiler; then three scans with
     DECIPHON_NO_CHAIN=1 (B6 and the classic B1 buckets); the ledger
     scans of both routes; then the
     unpacked scorer (plain buckets only, built through `scorer=`): first
     scan, three warm scans, one under torch.profiler; all with the same
     products; and a fresh Scanner's first scan after Scanner.warmup;
  5. the long-read scan: the same database and 3 reads of 24 knt, each
     carrying a planted domain, two of them in windows over the chain cap
     that ride the gang: first scan, one warm scan, one profiled; then one
     scan with DECIPHON_CHAIN_SEG=1 (carry segments, same products);
     then the large-K scan: six profiles of K 5200..16384 (three buckets
     past Kp 5120, on B4's clusters, survivors on B2's) and six reads of
     20 knt, three carrying planted stretches: first scan, three warm
     scans, one profiled; ledger scans of the long read, of its
     DECIPHON_CHAIN_SEG=1 scan (bkt_gangv, bkt_chainseg) and of the
     large-K scan (the `_hbm` buckets);
  5c. streamed tables: the Pfam scan with the table budget at half its
     table bytes (the largest scorers stream host->device per wave, the
     small buckets stay resident): first scan, three warm scans, one
     profiled (its host-to-device copy seconds), products byte-identical
     to phase 4's; then the long-read scan with a budget of 1 byte (every
     scorer streams, its gang runs B4m and never B5): first scan, one warm
     scan, one profiled, products byte-identical to phase 5's; B4m against
     B5 on every gang launch that scan made and against its plain version
     on the widest of them, bit for bit; the ledger scan of the streamed
     long read (bkt_gang: B4m); the peak allocation of the resident and
     streamed scans side by side;
 5d. the mid-K scan ("midk", `workload.pfam_midk`): 12 profiles, two in
     each plain bucket from 2560 to 5120 (K 2100..5100), where B1, B3, B5
     and B8 run on thread-block clusters, and six reads (four of 10 knt,
     chained; two of 24 knt, over the chain cap: the gang), three planted:
     first scan counted, three warm scans and one profiled, its ledger
     scan; DECIPHON_NO_CHAIN=1 (B1) and DECIPHON_CHAIN_SEG=1 (B8) counted,
     byte-identical to the default route; every launch at those widths
     on a cluster; K 2100 and 4608 on two reads of 1.2 knt on the card
     against the CPU (side pool), byte-identical;
  6. every kernel against its plain version again, on arguments the scans
     themselves gave it (more scans record each wrapper's calls): B7 and
     B2 with its walk from the Pfam scan and from the long-read scan, B6
     from the DECIPHON_NO_CHAIN=1 Pfam scan, B1, B3 and B5 from the
     long-read scan and every B8 call of its DECIPHON_CHAIN_SEG=1 scan,
     B4 from the large-K scan, B2 on that scan's widest launch (the
     largest cluster, over its first WIDEST_PATH_POSITIONS positions) and
     with its walk on its narrowest bucket; B6, B1, B5, B4 and B2 with
     its walks over their windows' first PREFIX_POSITIONS positions (the
     chain forms whole); B1, B3, B5 and B8 on the mid-K scans' widest
     launches, each timed alone on the card and held against its plain
     version (card pool): B1 and B5 over their windows' first
     PREFIX_POSITIONS positions, B3 whole, B8 on every carry call at the
     widest lanes on its own carry-in (times, plain times and errors under
     "midk" in the kernels line); per wrapper and
     scan the widest, longest launch, bit
     for bit; the times and bounds of a kernel's last check go into the
     kernels line, and the walk's time, ns a step and bound on each of the
     three scans' launches under its "scans";
  7. the same code on the card and on the CPU (plain versions) on a
     subset: at the reference's caps; on plain buckets with the chain caps
     shrunk and a 150-nt read added, so that the 1.2-knt windows ride the
     gang (B5 must launch on the card), carry segments
     (DECIPHON_CHAIN_SEG=1, B8 must launch) or, with every table
     streamed, the gang on B4m (which must launch, and B5 not); and on a
     large-K subset (K 5200 and 5300, two reads of 2 knt): products.tsv
     must be byte-identical; and
     Scanner(ScanConfig(engine="torch")) on the card on the subset at the
     reference's caps (the lax.scan engine's counterpart: plain PyTorch
     scores, then its own phase 2 through the walk kernel): the kernels'
     bytes, no score or path kernel launched, and the walk on its largest
     recorded call bit-equal to the plain walk;
  8. confirmation ("confirm"): the amino Forward and posterior kernels
     against their plain versions evaluated in f64 at AMINO_KPADS (16 to
     16384; L 1, degenerate residues, a batch of hits a launch) within the
     reference's tolerance (rtol 1e-4, atol 1e-3, scores in bits), each
     batch bit-equal to its hits launched one at a time; the Pfam scan
     with NativeConfirmer(pfam_scan_hmms(), device="cuda") on the batched
     route (a wave's hits to confirm_many, one launch a (wave, Kpad)
     group): first scan counted, three warm, one profiled (the kernels'
     device seconds, the warm median beside phase 4's unconfirmed one),
     its lines the unconfirmed scan's kept lines; the hit-by-hit route
     (one launch a hit) counted, the same hits and the same bytes; one
     counted scan with null2=False (the Forward kernel); the largest
     batched launch timed with its bound; the recorded call with the
     widest Kpad and the one with the longest L against the plain
     versions on the card; and the confirmed scan on the card against
     the CPU (the plain versions in f32 and in f64) on the Pfam subset
     and on `confirm_case` (hits kept and dropped, h3r files);
  9. the user's entry points ("cli"): the Pfam-shaped database written as
     HMMER3 text (`workload.hmm_text`), pressed by `press X.hmm 1`
     through the port's CLI (run in process: deciphon_tpu_torch.cli.main)
     and read back (`read_dcp_profiles`; press and read walls, .dcp
     bytes); 8 reads of 10 knt planted from the pressed profiles, as
     FASTA; `scan X.dcp reads.fna` on the card (first and one warm
     wall; B7, B3, B2 and the walk must launch), its products.tsv
     byte-identical to Scanner.run's and core.Scan's (snap members, not
     zip bytes); `see` showing the planted hits; `scan --confirm native`
     (posterior launched) byte-identical to the in-process Scanner with
     NativeConfirmer(read_hmm(X.hmm)); on a 12-profile subset pressed
     alone and two reads of 1.2 knt, the card's CLI scan byte-identical
     to `--device cpu`, on the planted read alone to `--engine native`
     and, against the planted profile pressed alone, to `--engine torch`
     (the walk launched on the card), and `warmup`;
 10. the device-parallel scan ("multi", parallel/): two shards on cuda:0
     (every card where there are more): the Pfam scan through
     BucketedPairScorer(devices=...) (first, median of 3 warm, one
     profiled, its device busy the union of its device intervals;
     launches per kernel key per shard; its ledger scan, with phase 4's
     bucket names and cells), the long-read scan under
     DECIPHON_CHAIN_SEG=1 (carry rows routed across shards), the large-K
     scan (B4 and phase 2 on the first device), and
     ScanConfig(engine="kernels-multi"), each byte-identical to its
     one-device phase's products; then two multihost_worker processes
     (gloo on localhost, --device cuda, the pfam workload, 100 + 100
     profiles): merged products byte-identical to phase 4's, their
     all-reduced counters equal to phase 4's metrics, each worker's wall
     and the merge's;
 11. the services ("services"), on phase 9's inputs: a scheduler in
     process (SchedServer on port 0) and an in-process worker on the card
     (WorkerLoop(Poster(url), engine="kernels", device="cuda")), driven
     through deciphonctl (deciphon_tpu_torch.control, in process): `hmm
     add pfam.hmm` (a press job: the .dcp pressed on the host, uploaded,
     byte-identical to phase 9's, listed by `db ls`); `scan post` of
     phase 9's reads, cold and warm on the worker's cached Scanner (B7,
     B3, B2 and the walk must launch; the snap's members phase 9's CLI
     scan's; the scheduler's seven snap views equal to the snap's own);
     a job on a second worker with confirm="native" (the first worker's
     Scanners released; it downloads the .dcp and the text; the
     posterior must launch; the snap's members those of phase 9's `scan
     --confirm native`); on phase 9's 12-profile subset, a job run by
     `python -m deciphon_tpu_torch.cli worker --device cuda` in a process
     of its own (it downloads the db; terminated afterwards, it must not
     have exited on its own), then the same job by the in-process card
     worker and by one on the CPU, all snaps phase 9's subset scan's;
     GuiController(device="cuda") pressing the subset (progress to 100)
     and naming the planted profile in the view of the planted read; a
     ScannerDaemon scan of the Pfam reads repeated DAEMON_READ_COPIES
     times, interrupted once its progress is above 0 (the port's
     Interrupted, no snap), then a request of the 8 reads served on the
     daemon's thread with phase 9's snap.  Every job must end `done` (a
     failed job's error is printed in full); walls of the press job, of
     each scan job (queue to done, and of it Scanner.run), of each .dcp
     upload and download, of the worker process's start to its first
     claimed job, and of the phase;
 12. the graft entry points ("entry", deciphon_tpu_torch/graft_entry.py):
     entry("cuda")'s scan step (ops/engine.scan_scores: plain PyTorch, no
     kernel) bit-equal to entry("cpu")'s, and B9 (GridScanEngine.scores)
     on the same profiles and windows within rtol 2e-6, atol 2e-5, bit
     for bit where the plain versions of the two are; dryrun_multichip(2,
     "cuda"): the production scan over two shards of the card against one
     device, byte-identical, with survivors, counted as a main path (its
     wall and survivors), its products phase 7's subset scan's.

Every scan path is run with the launch counts set to 0 just before and
read just after; each kernel must have launched on its path, and each
phase's paths must have launched its row of PHASE_KERNELS.  Under a
selection the closing checks (every kernel launched, every kernel timed
per DP position) cover only the selected phases' kernels, and a line
before the last says so.  The line before the last is a JSON object of per-kernel launches (summed over those
runs), errors, times, times per DP position (of the longest slot), bounds,
the ptxas registers and spills of each compiled instance (from the
build's -Xptxas -v report) and, for B4, B4m, B2, B9, B6 and B7, the launch
shape at every lane width they ran; the last line is {"ok": true, "device":
{...}}.  A kernel's bound is the least time the card could take for the
work of the measured call: the larger of its f32 add/min operations on
true profile nodes over the card's non-tensor f32 peak, and the bytes it
must move (every input once, every output once) over the memory rate.
Without a CUDA device, or outside a checkout, the script fails before any
result.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PALLAS = "deciphon_tpu/ops/viterbi_pallas.py"
SCORE_CU = "deciphon_tpu_torch/csrc/viterbi_score.cu"
PACKED_CU = "deciphon_tpu_torch/csrc/viterbi_packed.cu"
AMINO_CU = "deciphon_tpu_torch/csrc/amino_forward.cu"
FORWARD_PY = "deciphon_tpu/hmmer/forward.py"
SOURCE = {"score": SCORE_CU, "chain": SCORE_CU, "gang": SCORE_CU,
          "carry": SCORE_CU, "large": SCORE_CU, "gang_large": SCORE_CU,
          "packed": PACKED_CU,
          "pchain": PACKED_CU,
          "path": "deciphon_tpu_torch/csrc/viterbi_path.cu",
          "grid": SCORE_CU,
          "walk": "deciphon_tpu_torch/csrc/traceback_walk.cu",
          "amino_forward": AMINO_CU, "amino_posterior": AMINO_CU}
# kernel wrappers whose calls a captured scan records
SPIED = ("scores_pairs", "scores_pairs_mixed", "scores_pairs_chained",
         "scores_pairs_chained_carry", "scores_pairs_large",
         "scores_pairs_mixed_large", "scores_pairs_packed",
         "scores_pairs_packed_chained", "paths_pairs")
# plain versions by wrapper (B4's function is B1's, kept once)
PLAIN = {"scores_pairs_large": "scores_pairs_plain"}
REPLACES = {"score": f"{PALLAS}:376", "chain": f"{PALLAS}:1038",
            "gang": f"{PALLAS}:828", "carry": f"{PALLAS}:1111",
            "large": f"{PALLAS}:1379", "gang_large": f"{PALLAS}:1477",
            "packed": f"{PALLAS}:2265", "pchain": f"{PALLAS}:2331",
            "path": f"{PALLAS}:1707", "grid": f"{PALLAS}:158",
            "walk": "deciphon_tpu/ops/traceback.py:137",
            "amino_forward": f"{FORWARD_PY}:58",
            "amino_posterior": f"{FORWARD_PY}:128"}
# Published peaks of one H100 SXM: f32 outside the tensor cores (an FMA
# counted as two operations, so adds and mins alone reach half of it: the
# operation bound below is the generous one) and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32 adds and mins per (position, profile node) cell, counted from the
# kernel bodies.  Score family (`score_window_fast`,
# `score_window_packed_fast`):
# inner 3 adds + 2 mins, contrib 1 + 1, icand 2 + 1, the five pushes of M
# and of I 5 adds + 4 mins each, and at consume A, A - DDCUM, the prefix
# min, D, min(M, D) and the E reduction, one each: 34.  Path kernel: per
# fragment length the 4 match candidates (2 adds + 1 compare each) and the
# 2 insert candidates (2 + 1), five lengths: 90; delete chain 5; E and
# its first index 3: 98.  The grid kernel computes the score family's
# function (bit-equal to B1 on the same pairs), so its bound counts the
# same 34: the pull form's own steps (76 per cell: the M and I candidates
# redone per fragment length, 5 x (9 + 5), then the delete chain and E)
# are its excess over the bound, not part of it.  The per-position
# special states are O(1) per window and left out.
CELL_OPS = {"score": 34, "path": 98, "grid": 34}
# The amino Forward and posterior, f32 operations per (position, true
# node) cell of the function in the scaled odds space the kernels compute
# it in, an FMA counted as 2 and an exp as 1.  Forward: the emission's
# odds (1 exp), inner = M tmm + I tim + D tdm (1 mul, 2 FMA: 5), M' = e
# (inner r + B r tbm) (2 mul, 1 FMA: 4), I' = (M tmi + I tii) r (4), the
# D chain D'[k + 1] = M'[k] tmd + tdd D'[k] (3), E's two sums (2): 19.
# Backward: mb = e bM r (1 exp, 2 mul), bB's term (2), the alpha chain
# (3), bD = alpha + beta bE (2), bI r (1), bM (3 FMA: 6), bI (3), the
# usages gM and gI (3 each): 26.  The affine scans' composition of the
# chains' factors and the per-warp linear forms are the kernels' excess
# over this, not part of it; the specials are O(1) a position.
AMINO_OPS = {"amino_forward": 19, "amino_posterior": 19 + 26}
# Kpad at which the confirm phase holds both amino kernels against their
# plain versions (16384: the bucket of the largest profile, on a short
# string so that the plain version stays cheap)
AMINO_KPADS = (16, 128, 2048, 16384)
# planes (seg, nseg) on which phase 3 holds B6 and B7 against their plain
# versions
PACKED_PLANES = ((64, 4), (128, 8), (256, 8), (448, 2), (192, 6), (64, 32))
# lane widths at which phase 3 holds the clustered kernels (B4, B2) against
# their plain versions: 2176, the first clustered width, and the large-K
# buckets' and band widths of the card tests
CLUSTER_KPS = (2176, 2816, 3072, 5376, 5632, 8704, 16896)
# lane widths at which phase 3 holds B1, B3, B5 and B8 on clusters (the
# mid-K band of the plain buckets) against their plain versions: the first
# clustered width, a mid-band one and the widest plain bucket
MIDK_KPS = (2176, 3072, 5120)
# phase 6 holds B2 on the large-K scan's widest launch over the first this
# many positions of its windows (a prefix: the trellis rows of positions
# up to Lk do not depend on Lk), to bound its plain version's time
WIDEST_PATH_POSITIONS = 2048
# phase 6 holds B6 (Pfam, DECIPHON_NO_CHAIN=1), B1 and B5 (long read), B4
# (large K), and B2 with its walk on the Pfam, long-read and large-K
# narrowest launches over the first this many positions of their windows
# (10 to 24 knt), so that their host-bound plain versions fit the run's
# time; the chain forms (B3, B7, B8) run whole
PREFIX_POSITIONS = 6000
# the bucket ledgers' switches (scan/scheduler.py), set for a ledger scan
LEDGER_SWITCHES = {"DECIPHON_SYNC_DEBUG": "1", "DECIPHON_FILL_DEBUG": "1"}
# the LAUNCHES keys of the phase-1 kernels, each with the bucket-name
# prefix of its ledger entries (B1's and B4's classic buckets share
# bkt_kp; B4's end in _hbm)
BUCKET_PREFIXES = {"carry": "bkt_chainseg_", "chain": "bkt_chain_",
                   "gang": "bkt_gangv_", "gang_large": "bkt_gang_",
                   "pchain": "bkt_pchain_", "packed": "bkt_packed_",
                   "score": "bkt_kp", "large": "bkt_kp"}


def bucket_kernel(name: str) -> str:
    """The LAUNCHES key of a ledger entry's kernel."""
    if name.startswith("bkt_kp"):
        return "large" if name.endswith("_hbm") else "score"
    for k, pre in BUCKET_PREFIXES.items():
        if name.startswith(pre):
            return k
    fail(f"ledger name {name!r} names no kernel")


# the profile of a pfam_scan database whose domain pfam_subset plants in
# its first read
SUBSET_PLANTED = 100


# the kernels-line key each kernel instance serves, by its name and its
# first bool template argument
INSTANCE_KEYS = {("score_pairs_kernel", "false"): "score",
                 ("score_pairs_kernel", "true"): "gang",
                 ("score_chained_kernel", "false"): "chain",
                 ("score_chained_kernel", "true"): "carry",
                 ("score_large_kernel", "false"): "large",
                 ("score_large_kernel", "true"): "gang_large",
                 ("score_packed_chained_kernel", None): "pchain",
                 ("score_packed_kernel", None): "packed",
                 ("path_kernel", "false"): "path",
                 ("path_kernel", "true"): "path",
                 ("score_grid_kernel", "false"): "grid",
                 ("score_grid_kernel", "true"): "grid",
                 ("walk_kernel", None): "walk",
                 ("amino_kernel", "false"): "amino_forward",
                 ("amino_kernel", "true"): "amino_posterior"}


def ptxas_instances(log: str) -> dict:
    """{key: {instance: {registers, spill_stores, spill_loads}}} from the
    build's `-Xptxas -v` report; an instance is the kernel's name with its
    template arguments (b: bool, i: int)."""
    import re

    out: dict = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            base = re.search(r"\d+([a-z_]+_kernel)", name).group(1)
            targs = [("true" if v == "1" else "false") if t == "b" else v
                     for t, v in re.findall(r"L([bi])(\d+)E", name)]
            args = ",".join(targs)
            flag = next((a for a in targs if a in ("true", "false")), None)
            key = INSTANCE_KEYS[(base, flag)]
            cur = out.setdefault(key, {}).setdefault(
                f"{base}<{args}>" if args else base, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


@contextlib.contextmanager
def environ(env: dict):
    """Set environment switches for the duration of a block."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cuda_ms(torch, fn, reps: int = 1) -> float:
    """Mean device milliseconds of `reps` calls of fn (CUDA events)."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_err(torch, a, b) -> float:
    """Largest |a - b| over entries finite in both (0 where both +inf)."""
    d = torch.nan_to_num((a - b).abs(), nan=0.0, posinf=0.0)
    return float(d.max().item()) if d.numel() else 0.0


def kernel_vs_plain(torch, kernel, plain, args, reps=5):
    """Run a kernel and its plain version on the same CUDA tensors; return
    (kernel out, plain out, kernel ms, plain ms)."""
    out = kernel(**args)
    torch.cuda.synchronize()
    got = {}
    p_ms = cuda_ms(torch, lambda: got.update(r=plain(**args)))
    k_ms = cuda_ms(torch, lambda: kernel(**args), reps)
    return out, got["r"], k_ms, p_ms


# ---------------------------------------------------------------------------
# Pools of processes beside the card's: CPU work, and plain versions
# ---------------------------------------------------------------------------

SIDE_WORKERS = 2  # processes of the side pool (CPU only)
SIDE_THREADS = 2  # torch threads in each
CARD_WORKERS = 3  # processes of the card pool (plain versions on the card)
HELPER_NICE = 10  # the pools' and phase 10's workers' CPU priority below ours


def _side_init(here: str, card: bool) -> None:
    """A pool process: the checkout importable, SIDE_THREADS torch
    threads, no card in sight unless it is a card pool's, and a lower
    CPU priority (HELPER_NICE) than the card's process, whose work is the
    script's critical path."""
    os.nice(HELPER_NICE)
    if not card:
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch

    torch.set_num_threads(SIDE_THREADS)


class Side:
    """A pool of spawned processes beside the card's: the side pool's
    never see the card (CPU work: the CPU side of the card-against-CPU
    scans, the host data of the scans, the press), a card pool's
    (`card`) run plain versions on the card.  A job is submitted as soon
    as its inputs exist and read where a phase needs it.  The card's process only waits for a result it needs now
    (`get` prints the wait when there is one); a job that raises fails
    the phase that reads it."""

    def __init__(self, workers: int = SIDE_WORKERS, card: bool = False):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_side_init, initargs=(HERE, card))
        self.jobs: dict = {}
        self.waited = 0.0

    def submit(self, key, fn, *args) -> None:
        self.jobs[key] = self.pool.submit(fn, *args)

    def get(self, key):
        t0 = time.perf_counter()
        out = self.jobs.pop(key).result()
        dt = time.perf_counter() - t0
        self.waited += dt
        if dt >= 0.5:
            say("side", f"waited {dt:.1f} s for {key}")
        return out

    def close(self) -> None:
        """Stop every side process (at once where jobs are left: a phase
        failed)."""
        if self.jobs:
            for f in self.jobs.values():
                f.cancel()
            for p in list((self.pool._processes or {}).values()):
                p.terminate()
        self.pool.shutdown(wait=True, cancel_futures=True)


def side_job(fn, *args) -> dict:
    """Run fn(*args) in a side process with its printed lines captured;
    returns {"out": its result, "lines": what it printed, "failed": the
    message of a failed check or None}, so that the card's process prints
    the lines and fails where the job did."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
    except SystemExit:
        return {"out": None, "lines": buf.getvalue(), "failed": True}
    return {"out": out, "lines": buf.getvalue(), "failed": False}


def side_result(side: Side, key):
    """The result of the side job `key` (submitted through side_job): its
    lines printed here, its failed check failing here."""
    res = side.get(key)
    sys.stdout.write(res["lines"])
    sys.stdout.flush()
    check(not res["failed"], f"the side job {key} failed")
    return res["out"]


def digest(obj) -> str:
    """sha256 over the tensors (dtype, shape, bytes), arrays and values of
    a nest of dicts, lists and tuples: the same inputs on the card and in
    a side process give the same digest."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()

    def walk(o):
        if hasattr(o, "numel"):
            o = o.detach().cpu().contiguous().numpy()
        if isinstance(o, np.ndarray):
            h.update(f"{o.dtype}{o.shape}".encode())
            h.update(np.ascontiguousarray(o).tobytes())
        elif isinstance(o, dict):
            for k in sorted(o):
                h.update(str(k).encode())
                walk(o[k])
        elif isinstance(o, (list, tuple)):
            for x in o:
                walk(x)
        else:
            h.update(repr(o).encode())

    walk(obj)
    return h.hexdigest()


def to_np(o):
    """Tensors of a nest of dicts, lists and tuples as numpy arrays (what
    a side job hands back)."""
    if hasattr(o, "numel"):
        return o.detach().cpu().numpy()
    if isinstance(o, dict):
        return {k: to_np(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return type(o)(to_np(x) for x in o)
    return o


def to_torch(o, device: str):
    """The arrays of a nest of dicts, lists and tuples as tensors on
    `device`."""
    import numpy as np
    import torch

    if isinstance(o, np.ndarray):
        return torch.from_numpy(o).to(device)
    if isinstance(o, dict):
        return {k: to_torch(v, device) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return type(o)(to_torch(x, device) for x in o)
    return o


# phase 3's small cases whose plain versions run in the card pool: (kind,
# parameters); the inputs are built from each case's seed on either side
PLAIN3 = {"B1": "scores_pairs_plain", "B3": "scores_pairs_chained_plain",
          "B5": "scores_pairs_mixed_plain", "B6": "scores_pairs_packed_plain",
          "B7": "scores_pairs_packed_chained_plain",
          "B2": "paths_pairs_plain", "M1": "scores_pairs_plain",
          "M3": "scores_pairs_chained_plain",
          "M5": "scores_pairs_mixed_plain",
          "M8": "scores_pairs_chained_carry_plain"}


def cases3() -> list:
    """Phase 3's card-pool cases, in the order check_kernels reads them."""
    out = [("B1", Kp) for Kp in (256, 1024)]
    out += [("B3", Kp) for Kp in (256, 1024)]
    out += [("B5", Kp) for Kp in (256, 1024)]
    for seg, nseg in PACKED_PLANES:
        out += [("B6", seg, nseg), ("B7", seg, nseg, True),
                ("B7", seg, nseg, False)]
    out += [("B2", 256, 200, 2000, 8)]
    out += [("B2", Kp, 40, 300, 3) for Kp in CLUSTER_KPS]
    out += [(k, Kp) for Kp in MIDK_KPS for k in ("M1", "M3", "M5", "M8")]
    return out


def case3_inputs(case: tuple, device: str) -> tuple[dict, dict]:
    """(inputs, extra) of a phase-3 case on `device`: extra holds the
    longest window (`maxlen`) and B2's `nlb`."""
    from deciphon_tpu_torch import workload as wl
    from deciphon_tpu_torch.ops import viterbi as vk

    kind, *p = case
    if kind == "M1":  # mid-K: 8 windows of <= 600 nt, the last a pad
        inp, maxlen = wl.score_inputs(p[0], 8, 2, 100, 600, seed=160 + p[0],
                                      device=device)
        inp["lengths"][:, -1] = 0
        return inp, {"maxlen": int(inp["lengths"].max())}
    if kind == "M3":
        return wl.chain_case(p[0], seed=170 + p[0], device=device, cmax=4,
                             lo=40, hi=400), {}
    if kind == "M5":
        return wl.mixed_case(p[0], seed=180 + p[0], device=device, w=16,
                             hi=600), {}
    if kind == "M8":
        return wl.carry_case(p[0], seed=190 + p[0], device=device), {}
    if kind == "B1":
        inp, maxlen = wl.score_inputs(p[0], 32, 2, 400, 4000, seed=10 + p[0],
                                      device=device)
        return inp, {"maxlen": maxlen}
    if kind == "B3":
        return wl.chain_case(p[0], seed=40 + p[0], device=device, cmax=4,
                             lo=100, hi=1000), {}
    if kind == "B5":
        return wl.mixed_case(p[0], seed=50 + p[0], device=device, w=16,
                             hi=2000), {}
    if kind == "B6":
        return wl.packed_case(p[0], p[1], seed=70 + p[0], device=device,
                              hi=2000), {}
    if kind == "B7":
        return wl.packed_chain_case(p[0], p[1], seed=80 + p[0],
                                    device=device, cmax=4, lo=100, hi=1000,
                                    per_segment=p[2]), {}
    Kp, lo, hi, w = p
    inp, maxlen = wl.score_inputs(Kp, w, 1, lo, hi, seed=30 + Kp,
                                  device=device)
    if Kp > 2048:
        inp["lengths"][:, -1] = 0  # a pad among the clustered windows
        maxlen = int(inp["lengths"].max())
    return inp, {"maxlen": maxlen, "nlb": -(-maxlen // vk.PATH_KAPPA)}


def card_plain3(case: tuple) -> dict:
    """A card-pool job: the plain version of a phase-3 case on the card,
    on the inputs built from the case's seed; its output (numpy), its
    time (CUDA events, ms) and the inputs' digest."""
    import torch

    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.workload import run_carry_calls

    inp, extra = case3_inputs(case, "cuda")
    kw = {"nlb": extra["nlb"]} if "nlb" in extra else {}
    plain = getattr(vk, PLAIN3[case[0]])
    res: dict = {}
    if case[0] == "M8":  # the carry calls in turn
        ms = cuda_ms(torch, lambda: res.update(r=run_carry_calls(plain,
                                                                 inp)))
    else:
        ms = cuda_ms(torch, lambda: res.update(r=plain(**inp, **kw)))
    return {"digest": digest(inp), "out": to_np(res["r"]), "ms": ms}


def kernel_vs_card(torch, card: Side, case: tuple, kernel, args: dict,
                   reps: int = 5, **kw):
    """kernel_vs_plain with the plain version run in the card pool, on
    the case's inputs built there from the same seed (held to these by
    their digest): (kernel out, plain out, kernel ms, plain ms)."""
    out = kernel(**args, **kw)
    torch.cuda.synchronize()
    k_ms = cuda_ms(torch, lambda: kernel(**args, **kw), reps)
    res = card.get(("plain", case))
    check(res["digest"] == digest(args),
          f"{case}: the card pool built other inputs")
    return out, to_torch(res["out"], "cuda"), k_ms, res["ms"]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(report: dict, key: str, ops: float, byts: float) -> None:
    """Record the least time (ms) the card could take for `ops` f32
    operations and `byts` bytes moved, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, byts / PEAK_BYTES
    report[key].update(bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes
                       else "bytes", library_ms=None)


def core_sizes(torch, tvecs, nseg: int = 1):
    """True core size K of every profile (P,), or of every segment of
    every pack (P, nseg), read off the B->M row of the transition
    vectors (finite on the K real nodes only)."""
    P, _, Kp = tvecs.shape
    return torch.isfinite(tvecs[:, 0]).reshape(P, nseg, Kp // nseg).sum(-1)


def score_bound(torch, report, key: str, a: dict, outs) -> None:
    """Bound of one score-family call from its own arguments: cells are
    the positions its windows really have times the true core sizes."""
    tables, tvecs = a["tables"], a["tvecs"]
    nseg = a.get("nseg", 1)
    K = core_sizes(torch, tvecs, nseg).double()
    pidx = a["pidx"].long()
    if key in ("packed", "pchain"):
        if key == "packed":
            lens = a["lengths"][..., 0].double()  # (N, W)
            cells = (lens.sum(1)[:, None] * K[pidx]).sum()
            rows = lens.sum()
        else:
            lens = a["win_len"].double()  # (N, W, S, C)
            cells = (lens.sum((1, 3)) * K[pidx]).sum()
            rows = a["run_len"].double().sum()
    else:
        lens = (a["win_len"] if "win_len" in a else a["lengths"][..., 0])
        lens = lens.double()
        per_pair = lens.reshape(lens.shape[0], -1)
        if key in ("gang", "gang_large"):
            cells = (per_pair * K[:, 0][pidx]).sum()
        else:
            cells = (per_pair.sum(1) * K[:, 0][pidx]).sum()
        rows = lens.sum()
    used = torch.unique(pidx).numel()
    byts = (used * nbytes(tables[0], tvecs[0]) + float(rows) * 20
            + nbytes(*(v for k, v in a.items() if hasattr(v, "numel")
                       and k not in ("tables", "tvecs", "codes_all")))
            + nbytes(*outs))
    bound(report, key, CELL_OPS["score"] * float(cells), byts)


def carry_bound(torch, report, shared: dict, calls, outs) -> None:
    """Bound of a run of carry calls: their cells and bytes summed (each
    call reads and writes its carry planes)."""
    ops = byts = 0.0
    tmp = {"carry": {}}
    for call, out in zip(calls, outs):
        a = {k: v for k, v in call.items() if k != "route"}
        for k in ("tables", "tvecs", "xt_lut", "codes_all"):
            if k not in a:
                a[k] = shared[k]
        a.setdefault("cbig_in", out[2])  # the planes read are as large
        a.setdefault("csml_in", out[3])  # as the planes written
        score_bound(torch, tmp, "carry", a, out)
        t = tmp["carry"]["bound_ms"] / 1e3
        if tmp["carry"]["bound_by"] == "operations":
            ops += t * PEAK_F32_OPS
        else:
            byts += t * PEAK_BYTES
    bound(report, "carry", ops, byts)


def path_bound(torch, report, a: dict, xn) -> None:
    """Bound of one path call: cells as for the scores, and the trellis
    words of the positions the windows really have as output bytes."""
    tables, tvecs = a["tables"], a["tvecs"]
    Kp = tables.shape[2]
    lens = a["lengths"][..., 0].double()
    K = core_sizes(torch, tvecs).double()[:, 0][a["pidx"].long()]
    cells = float((lens.sum(1) * K).sum())
    rows = float(lens.sum())
    used = torch.unique(a["pidx"]).numel()
    byts = (used * nbytes(tables[0], tvecs[0]) + rows * 20
            + nbytes(a["xts"], a["lengths"], a["starts"], a["pidx"])
            + rows * 4 * (Kp + 1))
    bound(report, "path", CELL_OPS["path"] * cells, byts)


def walk_bound(report, ns) -> None:
    """Bound of a batch of walks: a step reads one trellis word (a special
    state its xnode word, a core state its node word) and writes one step
    (3 bytes), and computes next to nothing."""
    steps = float(ns.double().sum())
    bound(report, "walk", steps, steps * 7)


def check_kernels(torch, report, card: Side) -> None:
    """Phase 3: every kernel against its plain version at the scan's
    shapes; kernel launches made here are not counted toward any path.
    The plain versions of B1, B3, B5, B6, B7 and B2 run in the card
    pool's processes (their inputs built there from the same seeds, held
    to these by digest) beside this one, the others here."""
    import numpy as np

    from deciphon_tpu_torch.ops import traceback as tb
    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.workload import (carry_case, run_carry_calls,
                                             window_scores)

    for Kp in (256, 1024):
        inp, ex = case3_inputs(("B1", Kp), "cuda")
        maxlen = ex["maxlen"]
        (ka, kn), (pa, pn), k_ms, p_ms = kernel_vs_card(
            torch, card, ("B1", Kp), vk.scores_pairs, inp)
        exact = torch.equal(ka, pa) and torch.equal(kn, pn)
        fin = torch.isfinite(ka).all().item() and torch.isfinite(kn).all()
        report["score"].update(max_abs_err=max_err(torch, ka, pa), ms=k_ms)
        score_bound(torch, report, "score", inp, (ka, kn))
        say("B1", f"Kp={Kp} w=32 64 windows <= {maxlen} nt: bit-equal "
            f"{exact}, kernel {k_ms:.3f} ms ({k_ms * 1e3 / maxlen:.3f} "
            f"us/position), plain {p_ms:.1f} ms (card pool); bound "
            f"{report['score']['bound_ms']:.6f} ms")
        check(exact and bool(fin), f"B1 Kp={Kp} differs from plain")

    for Kp in (256, 1024):
        inp, _ = case3_inputs(("B3", Kp), "cuda")
        (ka, kn), (pa, pn), k_ms, p_ms = kernel_vs_card(
            torch, card, ("B3", Kp), vk.scores_pairs_chained, inp)
        real = inp["win_len"] > 0
        exact = (torch.equal(ka[real], pa[real])
                 and torch.equal(kn[real], pn[real]))
        pads = bool(torch.isinf(ka[~real]).all() and torch.isinf(ka[-1]).all())
        # B1 on the same windows, one per slot
        N, W, C = inp["win_len"].shape
        pidx = inp["pidx"]
        lens = inp["win_len"].reshape(N, W * C, 1).contiguous()
        xts = inp["xt_lut"][inp["win_xti"].reshape(N, W * C).long()]
        b1 = dict(pidx=pidx, tables=inp["tables"], tvecs=inp["tvecs"],
                  xts=xts.contiguous(), lengths=lens,
                  starts=inp["win_gstart"].reshape(N, W * C).contiguous(),
                  codes_all=inp["codes_all"])
        ba, bn = vk.scores_pairs(**b1)
        b1_ms = cuda_ms(torch, lambda: vk.scores_pairs(**b1), 5)
        same_b1 = (torch.equal(ba.reshape(N, W, C)[real], ka[real])
                   and torch.equal(bn.reshape(N, W, C)[real], kn[real]))
        say("B3", f"Kp={Kp} {int(real.sum())} windows <= "
            f"{int(inp['win_len'].max())} nt in {N - 1}x{W} slots of <= {C} "
            f"(+1 all-pad pair): bit-equal {exact}, pads +inf {pads}, equal "
            f"to B1 per window {same_b1}; kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.1f} ms (card pool), B1 on the same windows {b1_ms:.3f} "
            "ms")
        check(exact and pads and same_b1, f"B3 Kp={Kp} differs")
        report["chain"].update(max_abs_err=max_err(torch, ka, pa), ms=k_ms)
        score_bound(torch, report, "chain", inp, (ka, kn))

    for Kp in (256, 1024):
        inp, _ = case3_inputs(("B5", Kp), "cuda")
        (ka, kn), (pa, pn), k_ms, p_ms = kernel_vs_card(
            torch, card, ("B5", Kp), vk.scores_pairs_mixed, inp)
        exact = torch.equal(ka, pa) and torch.equal(kn, pn)
        say("B5", f"Kp={Kp} 2x16 slots over 3 profiles, windows <= "
            f"{int(inp['lengths'].max())} nt: bit-equal {exact}, kernel "
            f"{k_ms:.3f} ms, plain {p_ms:.1f} ms (card pool)")
        check(exact, f"B5 Kp={Kp} differs from plain")
        report["gang"].update(max_abs_err=max_err(torch, ka, pa), ms=k_ms)
        score_bound(torch, report, "gang", inp, (ka, kn))
    # B6 and B7 on planes of 2 and 4 lanes a thread: segments of 32, 64
    # and 128 threads, the Pfam scan's classes (448, 2) and (192, 6) (112
    # and 48 threads: a segment boundary inside a warp), 32 segments of 16
    # threads
    for seg, nseg in PACKED_PLANES:
        inp, _ = case3_inputs(("B6", seg, nseg), "cuda")
        (ka, kn), (pa, pn), k_ms, p_ms = kernel_vs_card(
            torch, card, ("B6", seg, nseg), vk.scores_pairs_packed, inp)
        exact = torch.equal(ka, pa) and torch.equal(kn, pn)
        shape = bool(torch.isfinite(ka[0, 0]).all()
                     and torch.isinf(ka[1, :, -1]).all()
                     and torch.isfinite(ka[1, 0, :-1]).all())
        L = int(inp["lengths"].max())
        say("B6", f"Kp={seg * nseg} ({nseg} segments of {seg} lanes) "
            f"{tuple(inp['lengths'].shape[:2])} slots over 2 packs, windows "
            f"<= {L} nt: bit-equal {exact}, full pack finite and the missing "
            f"segment +inf {shape}; kernel {k_ms:.3f} ms "
            f"({k_ms * 1e3 / L:.3f} us/position), plain {p_ms:.1f} ms on "
            f"the CPU; {packed_note(vk, report, 'packed', seg * nseg)}")
        check(exact and shape, f"B6 seg={seg} nseg={nseg} differs")
        report["packed"].update(max_abs_err=max_err(torch, ka, pa), ms=k_ms)
        score_bound(torch, report, "packed", inp, (ka, kn))

        for per_segment in (True, False):
            case = ("B7", seg, nseg, per_segment)
            inp, _ = case3_inputs(case, "cuda")
            (ka, kn), (pa, pn), k_ms, p_ms = kernel_vs_card(
                torch, card, case, vk.scores_pairs_packed_chained, inp)
            real = inp["win_len"] > 0
            exact = torch.equal(ka, pa) and torch.equal(kn, pn)
            pads = bool(torch.isinf(ka[~real]).all()
                        and torch.isfinite(ka[0][real[0]]).all())
            say("B7", f"Kp={seg * nseg} ({nseg} x {seg}) "
                f"{int(real.sum())} entries <= {int(inp['win_len'].max())} "
                f"nt, lists {'per segment' if per_segment else 'shared'}: "
                f"bit-equal {exact}, pads +inf and a full pack finite "
                f"{pads}; kernel {k_ms:.3f} ms "
                f"({k_ms * 1e3 / int(inp['win_len'].max()):.3f} us/position"
                f" of the longest entry), plain {p_ms:.1f} ms (card pool); "
                f"{packed_note(vk, report, 'pchain', seg * nseg)}")
            check(exact and pads, f"B7 seg={seg} nseg={nseg} differs")
            report["pchain"].update(max_abs_err=max_err(torch, ka, pa),
                                    ms=k_ms)
            score_bound(torch, report, "pchain", inp, (ka, kn))

    trellis = None
    for Kp, lo, hi, w in ((256, 200, 2000, 8),
                          *((Kp, 40, 300, 3) for Kp in CLUSTER_KPS)):
        inp, ex = case3_inputs(("B2", Kp, lo, hi, w), "cuda")
        maxlen, nlb = ex["maxlen"], ex["nlb"]
        (kx, kd), (px, pd), k_ms, p_ms = kernel_vs_card(
            torch, card, ("B2", Kp, lo, hi, w), vk.paths_pairs, inp, 3,
            nlb=nlb)
        lens = inp["lengths"].reshape(-1).tolist()
        exact, err = True, 0
        for i, n in enumerate(lens):
            if n == 0:  # a pad: no row is written
                continue
            a, b = kx[0, i, :n], px[0, i, :n]
            c, d = kd[0, i, :n], pd[0, i, :n]
            exact &= torch.equal(a, b) and torch.equal(c, d)
            err = max(err, int((a - b).abs().max()), int((c - d).abs().max()))
        pad = " (the last a pad)" if Kp > 2048 else ""
        say("B2", f"Kp={Kp} {w} windows <= {maxlen} nt{pad}: bit-equal "
            f"{exact}, "
            f"kernel {k_ms:.3f} ms ({k_ms * 1e3 / maxlen:.3f} us/position), "
            f"plain {p_ms:.1f} ms (card pool); {shape_note(vk, 'path', Kp)}")
        check(exact, f"B2 Kp={Kp} differs from plain")
        if trellis is None:
            report["path"].update(max_abs_err=float(err), ms=k_ms)
            path_bound(torch, report, inp, kx)
            trellis = (kx, kd, lens, Kp)

    kx, kd, lens, Kp = trellis
    W, Lk = kx.shape[1], kx.shape[2]
    xnf, ndf = kx.reshape(W, Lk), kd.reshape(W, Lk, Kp)
    rows = torch.arange(W, dtype=torch.int32, device="cuda")
    lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
    max_steps = Lk + 4 * Kp + 64
    ks = tb.walk(xnf, ndf, rows, lt, max_steps)
    torch.cuda.synchronize()
    plain = {}
    p_ms = cuda_ms(torch, lambda: plain.update(
        r=tb.walk_plain(xnf, ndf, rows, lt, max_steps)))
    k_ms = cuda_ms(torch, lambda: tb.walk(xnf, ndf, rows, lt, max_steps), 5)
    ps = plain["r"]
    ok_all = bool(ks[3].all())
    exact = all(torch.equal(a, b) for a, b in zip(ks, ps))
    # the steps as the pipeline assembles them, against the host oracle;
    # a second pass starts from 16 steps, so every walk overflows and is
    # walked again on the card
    xh, nh = xnf.cpu().numpy(), ndf.cpu().numpy()
    want = [tb.path_arrays(tb.unzip(*tb.host_trellis(xh[b], nh[b], n), n,
                                    Kp)) for b, n in enumerate(lens)]
    oracle = {}
    for steps in (max_steps, 16):
        first = tb.walk(xnf, ndf, rows, lt, steps)
        out, items = {}, [object() for _ in lens]
        tb.REWALKS["survivors"] = 0
        tb.assemble_path_entries(
            [(items, *first, xnf, ndf, rows.tolist(), lens)],
            [a.cpu().numpy() for a in first], out)
        oracle[steps] = (tb.REWALKS["survivors"], all(
            np.array_equal(out[id(it)][0], w[0])
            and np.array_equal(out[id(it)][1], w[1])
            for it, w in zip(items, want)))
    say("walk", f"{W} walks: ok {ok_all}, bit-equal to plain {exact}, equal "
        f"to host unzip {oracle[max_steps][1]} ({oracle[max_steps][0]} "
        f"re-walked) and from 16 steps {oracle[16][1]} ({oracle[16][0]} "
        f"re-walked), kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
    check(ok_all and exact and oracle[max_steps] == (0, True)
          and oracle[16] == (W, True), "walk differs from plain or unzip")
    report["walk"].update(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms)
    walk_bound(report, ks[2])
    # the plain versions that run here, once the card pool's are done
    check_mixed_large(torch, report)

    for Kp in (256, 1024):
        case = carry_case(Kp, seed=60 + Kp, device="cuda")
        got = run_carry_calls(vk.scores_pairs_chained_carry, case)
        torch.cuda.synchronize()
        res = {}
        p_ms = cuda_ms(torch, lambda: res.update(r=run_carry_calls(
            vk.scores_pairs_chained_carry_plain, case)))
        want = res["r"]
        k_ms = cuda_ms(torch, lambda: run_carry_calls(
            vk.scores_pairs_chained_carry, case), 5)
        wa, wn = window_scores(case["tables"], case["tvecs"],
                               case["codes_all"], 0,
                               [case["whole"]] + case["rides"])
        last = len(got) - 1
        exact, err = True, 0.0
        for t, (g, w) in enumerate(zip(got, want)):
            slots = [0, 1] if t == last else [1]
            for s in slots:
                exact &= (torch.equal(g[0][0, s, 0], w[0][0, s, 0])
                          and torch.equal(g[1][0, s, 0], w[1][0, s, 0]))
                err = max(err, max_err(torch, g[0][0, s, 0], w[0][0, s, 0]))
            if t < last:
                exact &= (torch.equal(g[2][:, :, 0], w[2][:, :, 0])
                          and torch.equal(g[3][:, :, 0], w[3][:, :, 0]))
            exact &= bool(g[0][0, 1, 0] == wa[1 + t]
                          and g[1][0, 1, 0] == wn[1 + t])
        whole = bool(got[last][0][0, 0, 0] == wa[0]
                     and got[last][1][0, 0, 0] == wn[0])
        L = case["whole"][1] - case["whole"][0]
        say("B8", f"Kp={Kp} {L}-nt window over {len(got)} carry calls with "
            f"carry_permute + a riding window per call: bit-equal to plain "
            f"(scores and continuing carry planes) {exact}, equal to B1 on "
            f"the whole window {whole}; kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.1f} ms for the {len(got)} calls")
        check(exact and whole, f"B8 Kp={Kp} differs")
        report["carry"].update(max_abs_err=err, ms=k_ms, plain_ms=p_ms)
        carry_bound(torch, report, case, case["calls"], got)
    check_walk_cases(torch)
    check_large(torch, report)
    check_midk(torch, card)


def check_walk_cases(torch) -> None:
    """Phase 3, the walk on `walk_cases` (E jumping to k = 0 and Kp - 1,
    a D chain along a row, an I run down a column, stretches of special
    states, a domain from stage 1, a diagonal domain over most columns, an
    overflow at max_steps, an underflow and a length-0 walk) at Kp 1024 x
    Lk 4096 (16-byte copies) and Kp 37 x Lk 301 (4-byte copies, the torch
    engine's layout): bit-equal to the plain walk; through
    `assemble_path_entries`, which walks the overflow again on the card,
    equal to each case's planted path; the underflow raises in `rewalk`."""
    import numpy as np

    from deciphon_tpu_torch.ops import traceback as tb
    from deciphon_tpu_torch.workload import assemble_walk_cases, walk_cases

    for Kp, Lk in ((1024, 4096), (37, 301)):
        c = walk_cases(Kp, Lk, seed=Kp, device="cuda")
        args = [c[k] for k in ("xn", "nd", "rows", "lengths")]
        steps = c["max_steps"]
        got = tb.walk(*args, steps)
        torch.cuda.synchronize()
        plain = {}
        p_ms = cuda_ms(torch, lambda: plain.update(
            r=tb.walk_plain(*args, steps)))
        k_ms = cuda_ms(torch, lambda: tb.walk(*args, steps), 3)
        exact = all(torch.equal(a, b) for a, b in zip(got, plain["r"]))
        names, oks = c["names"], got[3].tolist()
        ok_as_planned = all(bool(ok) == (n not in ("overflow", "underflow",
                                                     "empty"))
                            for n, ok in zip(names, oks))
        # the walks that end (the overflow after its re-walk) as the
        # pipeline assembles them, against the planted paths
        tb.REWALKS["survivors"] = 0
        out = assemble_walk_cases(c, got)
        rewalked = tb.REWALKS["survivors"]
        planted = all(
            all(np.array_equal(x, y) for x, y in zip(
                path, tb.path_arrays(c["paths"][b])))
            for b, path in out.items())
        b = names.index("underflow")
        try:
            tb.rewalk(c["xn"], c["nd"], [int(c["rows"][b])], [2], steps)
            raised = False
        except RuntimeError:
            raised = True
        say("walk", f"walk_cases Kp={Kp} Lk={Lk}: {len(names)} walks "
            f"({', '.join(f'{n} {int(k)}' for n, k in zip(names, got[2]))}"
            f" steps), max_steps {steps}: bit-equal to plain {exact}, ok as "
            f"planned {ok_as_planned}, paths as planted {planted} "
            f"({rewalked} re-walked on the card), underflow raises "
            f"{raised}; kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        check(exact and ok_as_planned and planted and rewalked == 1
              and raised, f"walk differs on walk_cases Kp={Kp}")


def packed_note(vk, report, key: str, Kp: int) -> str:
    """The launch shape B6 or B7 used at lane width Kp, the CTAs an SM
    holds at once, and the instance's ptxas registers and spills."""
    s = vk.SHAPES[(key, Kp)]
    base = ("score_packed_kernel" if key == "packed"
            else "score_packed_chained_kernel")
    p = report[key]["ptxas"][f"{base}<{s['lpt']}>"]
    return (f"lpt={s['lpt']} threads={s['threads']} smem={s['smem']} B, "
            f"{s['active']} CTAs an SM; {base}<{s['lpt']}> "
            f"{p['registers']} registers, {p['spill_stores']} B spill "
            f"stores")


def shape_note(vk, key: str, Kp: int) -> str:
    """The launch shape a clustered wrapper last used at lane width Kp."""
    s = vk.SHAPES[(key, Kp)]
    note = (f"c={s['c']} w={s['w']} lpt={s['lpt']} threads={s['threads']} "
            f"smem={s['smem']} B")
    if s["c"] > 1:
        note += f", {s['active']} clusters resident at once"
    return note


def check_mixed_large(torch, report) -> None:
    """Phase 3, B4m: 2 x 16 slots over three profiles (a different one in
    neighbouring slots, one pad per pair) at Kp 512, 1024 (one CTA a
    window: B5's kernel), 5120 and 16896 (clusters), against the one plain
    version of the gang's function and, where B5 takes the width, against
    B5 on the same arguments, bit for bit, with both kernels' times; the
    bound counts 34 operations a cell, as for B1 and B4."""
    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.workload import mixed_case

    for Kp, hi in ((512, 2000), (1024, 2000), (5120, 600), (16896, 300)):
        inp = mixed_case(Kp, seed=150 + Kp, device="cuda", w=16, hi=hi)
        (ka, kn), (pa, pn), k_ms, p_ms = kernel_vs_plain(
            torch, vk.scores_pairs_mixed_large, vk.scores_pairs_mixed_plain,
            inp)
        exact = torch.equal(ka, pa) and torch.equal(kn, pn)
        b5 = "B5 does not take this width"
        same = True
        if Kp <= vk.MAX_KP:
            ba, bn = vk.scores_pairs_mixed(**inp)
            b5_ms = cuda_ms(torch, lambda: vk.scores_pairs_mixed(**inp), 5)
            same = torch.equal(ka, ba) and torch.equal(kn, bn)
            b5 = f"B5 {b5_ms:.3f} ms, bit-equal to B5 {same}"
        pads = bool(torch.isinf(ka[:, -1]).all()
                    and torch.isfinite(ka[:, :-1]).all())
        L = int(inp["lengths"].max())
        report["gang_large"].update(max_abs_err=max_err(torch, ka, pa),
                                    ms=k_ms, plain_ms=p_ms)
        score_bound(torch, report, "gang_large", inp, (ka, kn))
        say("B4m", f"Kp={Kp} 2x16 slots over 3 profiles, windows <= {L} "
            f"nt: bit-equal to plain {exact}, pads +inf {pads}; B4m "
            f"{k_ms:.3f} ms ({k_ms * 1e3 / L:.3f} us/position), {b5}, plain "
            f"{p_ms:.1f} ms; bound "
            f"{report['gang_large']['bound_ms']:.6f} ms "
            f"({report['gang_large']['bound_by']}); "
            f"{shape_note(vk, 'gang_large', Kp)}")
        check(exact and same and pads, f"B4m Kp={Kp} differs")


def check_large(torch, report) -> None:
    """Phase 3, the large-K tier: B4 on 8 windows of <= 600 nt (the last a
    pad) against B1 at Kp 1024 (one CTA a window) and 5120 (a cluster, B1
    on the same one), and against its plain version on clusters at
    CLUSTER_KPS (B2 at those widths is checked with the other B2 cases)."""
    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.workload import score_inputs

    for Kp in (1024, 5120, *CLUSTER_KPS):
        inp, maxlen = score_inputs(Kp, 8, 1, 100, 600, seed=90 + Kp,
                                   device="cuda")
        inp["lengths"][:, -1] = 0
        if Kp in (1024, 5120):
            a1, n1 = vk.scores_pairs(**inp)
            a4, n4 = vk.scores_pairs_large(**inp)
            torch.cuda.synchronize()
            b1_ms = cuda_ms(torch, lambda: vk.scores_pairs(**inp), 5)
            b4_ms = cuda_ms(torch, lambda: vk.scores_pairs_large(**inp), 5)
            same = torch.equal(a1, a4) and torch.equal(n1, n4)
            say("B4", f"Kp={Kp} 7 windows <= {maxlen} nt + 1 pad: equal to "
                f"B1 bit for bit {same}; B4 {b4_ms:.3f} ms "
                f"({b4_ms * 1e3 / maxlen:.3f} us/position), B1 "
                f"{b1_ms:.3f} ms ({b1_ms * 1e3 / maxlen:.3f} us/position); "
                f"{shape_note(vk, 'large', Kp)}")
            check(same, f"B4 differs from B1 at Kp={Kp}")
            continue
        (ka, kn), (pa, pn), k_ms, p_ms = kernel_vs_plain(
            torch, vk.scores_pairs_large, vk.scores_pairs_plain, inp)
        exact = torch.equal(ka, pa) and torch.equal(kn, pn)
        pads = bool(torch.isinf(ka[:, -1]).all()
                    and torch.isfinite(ka[:, :-1]).all())
        say("B4", f"Kp={Kp} 7 windows <= {maxlen} nt + 1 pad: bit-equal "
            f"{exact}, pad +inf and real slots finite {pads}; kernel "
            f"{k_ms:.3f} ms ({k_ms * 1e3 / maxlen:.3f} us/position), plain "
            f"{p_ms:.1f} ms; {shape_note(vk, 'large', Kp)}")
        check(exact and pads, f"B4 Kp={Kp} differs from plain")
        check(vk.SHAPES[("large", Kp)]["c"] > 1, f"B4 Kp={Kp} not clustered")
        report["large"].update(max_abs_err=max_err(torch, ka, pa), ms=k_ms,
                               plain_ms=p_ms)
        score_bound(torch, report, "large", inp, (ka, kn))
    check_grid(torch)


def check_midk(torch, card: Side) -> None:
    """Phase 3, the mid-K band: B1 (8 windows of <= 600 nt, a pad each
    pair), B3 (chains of up to 4 windows of <= 400 nt and an all-pad
    pair), B5 (2 x 16 slots over three profiles) and B8 (a 13-block window
    over 4 carry calls, a normal window riding in a spare slot) at
    MIDK_KPS, each on a cluster, against its plain version (card pool) bit
    for bit, B8's segments against B1 on the whole window; the kernels' times per
    position and launch shapes.  These launches count toward no path."""
    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.workload import run_carry_calls, window_scores

    for Kp in MIDK_KPS:
        inp, ex = case3_inputs(("M1", Kp), "cuda")
        L = ex["maxlen"]
        (ka, kn), (pa, pn), k_ms, p_ms = kernel_vs_card(
            torch, card, ("M1", Kp), vk.scores_pairs, inp)
        exact = torch.equal(ka, pa) and torch.equal(kn, pn)
        pads = bool(torch.isinf(ka[:, -1]).all()
                    and torch.isfinite(ka[:, :-1]).all())
        say("B1", f"mid-K Kp={Kp} 2x8 windows <= {L} nt (a pad a pair): "
            f"bit-equal {exact}, pads +inf {pads}; kernel {k_ms:.3f} ms "
            f"({k_ms * 1e3 / L:.3f} us/position), plain {p_ms:.1f} ms "
            f"(card pool); {shape_note(vk, 'score', Kp)}")
        check(exact and pads, f"B1 Kp={Kp} differs")

        inp, _ = case3_inputs(("M3", Kp), "cuda")
        (ka, kn), (pa, pn), k_ms, p_ms = kernel_vs_card(
            torch, card, ("M3", Kp), vk.scores_pairs_chained, inp)
        real = inp["win_len"] > 0
        exact = torch.equal(ka, pa) and torch.equal(kn, pn)
        pads = bool(torch.isinf(ka[~real]).all()
                    and torch.isfinite(ka[real]).all())
        L = int(inp["win_len"].max())
        say("B3", f"mid-K Kp={Kp} {int(real.sum())} windows <= {L} nt in "
            f"chains of <= 4 (+1 all-pad pair): bit-equal {exact}, pads "
            f"+inf {pads}; kernel {k_ms:.3f} ms ({k_ms * 1e3 / L:.3f} "
            f"us/position of the longest entry), plain {p_ms:.1f} ms (card "
            f"pool); {shape_note(vk, 'chain', Kp)}")
        check(exact and pads, f"B3 Kp={Kp} differs")

        inp, _ = case3_inputs(("M5", Kp), "cuda")
        (ka, kn), (pa, pn), k_ms, p_ms = kernel_vs_card(
            torch, card, ("M5", Kp), vk.scores_pairs_mixed, inp)
        exact = torch.equal(ka, pa) and torch.equal(kn, pn)
        L = int(inp["lengths"].max())
        say("B5", f"mid-K Kp={Kp} 2x16 slots over 3 profiles, windows <= "
            f"{L} nt: bit-equal {exact}; kernel {k_ms:.3f} ms "
            f"({k_ms * 1e3 / L:.3f} us/position), plain {p_ms:.1f} ms "
            f"(card pool); {shape_note(vk, 'gang', Kp)}")
        check(exact, f"B5 Kp={Kp} differs")

        case, _ = case3_inputs(("M8", Kp), "cuda")
        got = run_carry_calls(vk.scores_pairs_chained_carry, case)
        torch.cuda.synchronize()
        k_ms = cuda_ms(torch, lambda: run_carry_calls(
            vk.scores_pairs_chained_carry, case), 5)
        res = card.get(("plain", ("M8", Kp)))
        check(res["digest"] == digest(case),
              f"M8 Kp={Kp}: the card pool built other inputs")
        want = to_torch(res["out"], "cuda")
        wa, wn = window_scores(case["tables"], case["tvecs"],
                               case["codes_all"], 0,
                               [case["whole"]] + case["rides"])
        last = len(got) - 1
        exact = True
        for t, (g, w) in enumerate(zip(got, want)):
            for s in ([0, 1] if t == last else [1]):
                exact &= (torch.equal(g[0][0, s, 0], w[0][0, s, 0])
                          and torch.equal(g[1][0, s, 0], w[1][0, s, 0]))
            if t < last:
                exact &= (torch.equal(g[2][:, :, 0], w[2][:, :, 0])
                          and torch.equal(g[3][:, :, 0], w[3][:, :, 0]))
            exact &= bool(g[0][0, 1, 0] == wa[1 + t]
                          and g[1][0, 1, 0] == wn[1 + t])
        whole = bool(got[last][0][0, 0, 0] == wa[0]
                     and got[last][1][0, 0, 0] == wn[0])
        L = case["whole"][1] - case["whole"][0]
        say("B8", f"mid-K Kp={Kp} {L}-nt window over {len(got)} carry calls "
            f"+ a riding window per call: bit-equal to plain (scores and "
            f"continuing carry planes) {exact}, segments equal to B1 on the "
            f"whole window {whole}; kernel {k_ms:.3f} ms "
            f"({k_ms * 1e3 / L:.3f} us/position of the segmented window), "
            f"plain {res['ms']:.1f} ms (card pool) for the {len(got)} "
            f"calls; {shape_note(vk, 'carry', Kp)}")
        check(exact and whole, f"B8 Kp={Kp} differs")
        for key in ("score", "chain", "gang", "carry"):
            check(vk.SHAPES[(key, Kp)]["c"] > 1,
                  f"{key} at Kp {Kp} did not run on a cluster")


def grid_pairs(torch, g: dict) -> dict:
    """B1's inputs for every (profile, window) pair of a B9 call: pair p
    holds all the windows in its slots."""
    P, B = g["tables"].shape[0], g["starts"].shape[0]
    return dict(pidx=torch.arange(P, dtype=torch.int32, device="cuda"),
                tables=g["tables"], tvecs=g["tvecs"],
                xts=g["xts"].expand(P, B, 16).contiguous(),
                lengths=g["lengths"][:, None].expand(P, B, 1).contiguous(),
                starts=g["starts"].expand(P, B).contiguous(),
                codes_all=g["codes_all"])


def push_form(vk, Kp: int):
    """B1, or B4 past B1's lanes: the push form of the same function."""
    return ((vk.scores_pairs, "B1") if Kp <= vk.MAX_KP
            else (vk.scores_pairs_large, "B4"))


def check_grid(torch) -> None:
    """Phase 3, B9: two profiles (K = Kp - 2 and Kp // 2) against 9
    windows of <= 600 nt (one a pad, one of length 1) at Kp 128, 512, 1024,
    2048 (the last one-CTA width), 2176 (the first clustered one) and
    5632, against the plain version and against the push form on the same
    pairs, with both times per position and B9's launch shape."""
    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.workload import score_inputs

    for Kp in (128, 512, 1024, 2048, 2176, 5632):
        inp, maxlen = score_inputs(Kp, 9, 1, 100, 600, seed=120 + Kp,
                                   device="cuda")
        inp["lengths"][0, 3] = 0
        inp["lengths"][0, 5] = 1
        g = dict(tables=inp["tables"], tvecs=inp["tvecs"],
                 xts=inp["xts"][0].contiguous(),
                 lengths=inp["lengths"][0, :, 0].contiguous(),
                 starts=inp["starts"][0].contiguous(),
                 codes_all=inp["codes_all"])
        (ka, kn), (pa, pn), k_ms, p_ms = kernel_vs_plain(
            torch, vk.scores_grid, vk.scores_grid_plain, g)
        exact = torch.equal(ka, pa) and torch.equal(kn, pn)
        pads = bool(torch.isinf(ka[:, 3]).all()
                    and torch.isfinite(ka[:, 5]).all())
        push, name = push_form(vk, Kp)
        pairs = grid_pairs(torch, g)
        a1, n1 = push(**pairs)
        torch.cuda.synchronize()
        b1_ms = cuda_ms(torch, lambda: push(**pairs), 5)
        same = torch.equal(a1, ka) and torch.equal(n1, kn)
        say("B9", f"Kp={Kp} 2 profiles x 9 windows <= {maxlen} nt (a pad, "
            f"a length-1): bit-equal {exact}, pad +inf {pads}, equal to "
            f"{name} on the same pairs {same}; B9 {k_ms:.3f} ms "
            f"({k_ms * 1e3 / maxlen:.3f} us/position), {name} {b1_ms:.3f} ms "
            f"({b1_ms * 1e3 / maxlen:.3f} us/position), plain {p_ms:.1f} ms; "
            f"{shape_note(vk, 'grid', Kp)}")
        check(exact and pads and same, f"B9 Kp={Kp} differs")


GRID_SHAPES = ((400, 128), (1000, 128), (16382, 8))  # (K, windows)


def grid_costs(K: int, P: int = 8):
    """Phase 3b's profiles at core size K, sample_profile(100 + i, K), as
    costs (built in the side pool where the script asked it to):
    (costs, seconds)."""
    from deciphon_tpu_torch.ops.costs import build_costs
    from deciphon_tpu_torch.profile import sample_profile

    t0 = time.perf_counter()
    costs = [build_costs(sample_profile(seed=100 + i, core_size=K))
             for i in range(P)]
    return costs, time.perf_counter() - t0


def grid_full_width(torch, report, launches: dict, side: Side) -> None:
    """Phase 3b: the dense grid at `bench.py`'s kernel shapes (8 profiles
    sample_profile(100 + i, K), windows of 4096 nt from
    default_rng(3); 128 windows at K 400 and 1000, 8 at K 16382), through
    GridScanEngine.scores on the card with the launch counts set to 0
    just before and read just after.  Then, on the same device inputs:
    B9's time (median of 3 calls), GCUPS and bound, B1 (B4 past its
    lanes) on the same pairs and B9's plain version, bit for bit.  The
    kernels line keeps the K 400 shape (bench.py's default)."""
    import numpy as np

    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.scan.sequence import frag_codes_ending
    from deciphon_tpu_torch.xtrans import xtrans_cost_vector

    P, L = 8, 4096
    for K, B in GRID_SHAPES:
        key = ("grid costs", K)
        if key in side.jobs:
            costs, c_s = side_result(side, key)
            made = f"profiles {c_s:.1f} s (side pool)"
        else:
            costs, c_s = grid_costs(K, P)
            made = f"profiles {c_s:.1f} s"
        t0 = time.perf_counter()
        rng = np.random.default_rng(3)
        codes = np.zeros((B, L, 5), np.int32)
        xt = np.zeros((B, 13), np.float32)
        for b in range(B):
            codes[b] = frag_codes_ending(
                rng.integers(0, 4, size=L).astype(np.int8))
            xt[b] = xtrans_cost_vector(True, False, L)
        lengths = np.full((B,), L, np.int32)
        eng = vk.GridScanEngine(costs, device="cuda")
        Kp = eng.tables.shape[2]
        setup = time.perf_counter() - t0  # reads, tables on the card

        torch.cuda.synchronize()
        vk.reset_launches()
        t0 = time.perf_counter()
        nul, alt = eng.scores(xt, codes, lengths)
        wall = time.perf_counter() - t0
        counts = dict(vk.LAUNCHES)
        check(counts["grid"] == 1 and sum(counts.values()) == 1,
              f"GridScanEngine.scores launched {counts}")
        launches["grid"] = launches.get("grid", 0) + counts["grid"]
        check(alt.shape == nul.shape == (P, B) and np.isfinite(alt).all()
              and np.isfinite(nul).all(), "grid scores not finite")

        g = dict(zip(("xts", "lengths", "starts", "codes_all"),
                     eng.grid_inputs(xt, codes, lengths)),
                 tables=eng.tables, tvecs=eng.tvecs)
        out = {}
        times = [cuda_ms(torch, lambda: out.update(r=vk.scores_grid(**g)))
                 for _ in range(3)]
        k_ms = statistics.median(times)
        ka, kn = out["r"]
        same_scores = (np.array_equal(ka.cpu().numpy(), alt)
                       and np.array_equal(kn.cpu().numpy(), nul))
        push, name = push_form(vk, Kp)
        pairs = grid_pairs(torch, g)
        times = [cuda_ms(torch, lambda: out.update(r=push(**pairs)))
                 for _ in range(3)]
        b1_ms = statistics.median(times)
        same_b1 = torch.equal(out["r"][0], ka) and torch.equal(out["r"][1],
                                                               kn)
        p_ms = cuda_ms(torch, lambda: out.update(
            r=vk.scores_grid_plain(**g)))
        pa, pn = out["r"]
        exact = torch.equal(pa, ka) and torch.equal(pn, kn)
        cells = P * B * L * 5 * K
        say("grid", f"K={K} (Kp {Kp}) {P} profiles x {B} windows of {L} nt, "
            f"{eng.tables.numel() * 4 / 1e9:.3f} GB of tables; host set-up: "
            f"{made}, reads and engine {setup:.1f} s; GridScanEngine.scores {wall:.3f} s (launches "
            f"{counts['grid']}); B9 {k_ms:.3f} ms ({k_ms * 1e3 / L:.3f} "
            f"us/position, {cells / (k_ms / 1e3) / 1e9:.3f} GCUPS); "
            f"{name} on the same pairs {b1_ms:.3f} ms "
            f"({cells / (b1_ms / 1e3) / 1e9:.3f} GCUPS), bit-equal "
            f"{same_b1}; plain {p_ms:.1f} ms, bit-equal {exact}; scores "
            f"equal to the engine's {same_scores}; "
            f"{shape_note(vk, 'grid', Kp)}")
        check(exact and same_b1 and same_scores,
              f"grid K={K} differs from plain or {name}")
        ops = CELL_OPS["grid"] * P * B * L * K
        byts = (nbytes(eng.tables, eng.tvecs, g["xts"], g["lengths"],
                       g["starts"], ka, kn) + B * L * 20)
        t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, byts / PEAK_BYTES * 1e3
        say("grid", f"K={K}: bound {max(t_ops, t_bytes):.6f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}; "
            f"operations {t_ops:.6f} ms, bytes {t_bytes:.6f} ms), B9 at "
            f"{k_ms / max(t_ops, t_bytes):.1f}x it")
        if K == 400:
            report["grid"].update(max_abs_err=max_err(torch, ka, pa),
                                  ms=k_ms, plain_ms=p_ms,
                                  us_per_position=k_ms * 1e3 / L)
            bound(report, "grid", ops, byts)
        del eng, g, pairs, out, ka, kn, pa, pn


def span(a: dict) -> int:
    """DP positions of the longest slot of one recorded launch."""
    from deciphon_tpu_torch.ops import viterbi as vk

    if "win_len" in a:
        return int((a["win_sblk"] * vk.KAPPA + a["win_len"]).max())
    return int(a["lengths"].max())


def widest(calls: list, key: str, narrowest: bool = False):
    """The recorded launch with the widest (or the narrowest) lanes, then
    the longest slot."""
    check(calls, f"the captured scan made no {key} launch")
    sign = -1 if narrowest else 1
    i = max(range(len(calls)), key=lambda j: (
        sign * calls[j]["tables"].shape[2], span(calls[j])))
    return i, calls[i]


def record(report, key: str, err: float, k_ms: float, p_ms: float,
           positions: int) -> None:
    """A kernel's check into the kernels line: its error, times and time
    per DP position (kernel ms over the positions of the longest slot, the
    ones a CTA runs in series)."""
    report[key].update(max_abs_err=max(report[key].get("max_abs_err", 0.0),
                                       err),
                       ms=k_ms, plain_ms=p_ms,
                       us_per_position=k_ms * 1e3 / positions)


def card_plain_call(name: str, args: dict) -> dict:
    """A card-pool job: the plain version `name` (of ops.viterbi) on the
    card, on a recorded call's arguments (numpy, from the card's main
    process): its output (numpy) and its time (CUDA events, ms)."""
    import torch

    from deciphon_tpu_torch.ops import viterbi as vk

    a = to_torch(args, "cuda")
    res: dict = {}
    ms = cuda_ms(torch, lambda: res.update(r=getattr(vk, name)(**a)))
    return {"out": to_np(res["r"]), "ms": ms}


def check_main_shapes(torch, report, pfam_calls, nochain_calls, long_calls,
                      seg_calls, big_calls, card: Side, midk: list) -> None:
    """Each kernel against its plain version on arguments the scans
    themselves gave it (recorded by captured scans): B7 and B2 from the
    Pfam scan and again from the long-read scan (whole-read
    windows), B6 from the Pfam DECIPHON_NO_CHAIN=1 scan, B1, B5 and B3
    from the long-read scan, B4 from the large-K scan; per wrapper and
    scan the launch with the widest lanes and then the longest slot, and
    every carry call of the long-read DECIPHON_CHAIN_SEG=1 scan on its own
    carry-in; B2 also from the large-K scan's narrowest bucket (its
    longest launch), to bound the plain version's time; the walk on each
    chosen path launch's trellis, as the scheduler runs it.  Bit for bit,
    pads +inf on both sides.  The times of a kernel's last check go into
    the kernels line.  Every kernel is run and timed first, alone on the
    card; then the plain versions of the score kernels and of each carry
    call run in the card pool's processes while this one runs B2's and
    the walk's, one after another; the plain versions of `midk` (time_midk's
    runs, made before this) go to the card pool with the others."""
    from deciphon_tpu_torch.ops import viterbi as vk

    # 1. every kernel, alone on the card
    entries = []
    for key, name, scan, calls, prefix in (
            ("pchain", "scores_pairs_packed_chained", "Pfam", pfam_calls,
             None),
            ("packed", "scores_pairs_packed", "Pfam DECIPHON_NO_CHAIN=1",
             nochain_calls, PREFIX_POSITIONS),
            ("pchain", "scores_pairs_packed_chained", "long-read",
             long_calls, None),
            ("score", "scores_pairs", "long-read", long_calls,
             PREFIX_POSITIONS),
            ("gang", "scores_pairs_mixed", "long-read", long_calls,
             PREFIX_POSITIONS),
            ("chain", "scores_pairs_chained", "long-read", long_calls, None),
            ("large", "scores_pairs_large", "large-K", big_calls,
             PREFIX_POSITIONS)):
        calls = calls[name]
        i, args = widest(calls, key)
        full = span(args)
        if prefix is not None:  # each window's first `prefix` positions
            args = dict(args, lengths=args["lengths"].clamp(max=prefix))
        kernel = getattr(vk, name)
        out = kernel(**args)
        torch.cuda.synchronize()
        k_ms = cuda_ms(torch, lambda: kernel(**args), 2)
        entries.append((key, name, scan, len(calls), i, args, full, out,
                        k_ms))
    carry = seg_calls["scores_pairs_chained_carry"]
    check(carry, "the DECIPHON_CHAIN_SEG=1 scan made no carry launch")
    carry_runs = []
    for args in carry:
        out = vk.scores_pairs_chained_carry(**args)
        torch.cuda.synchronize()
        carry_runs.append((args, out, cuda_ms(
            torch, lambda: vk.scores_pairs_chained_carry(**args))))
    paths = [path_kernel(torch, *a) for a in (
        ("Pfam", pfam_calls, False, PREFIX_POSITIONS, True),
        ("long-read", long_calls, False, PREFIX_POSITIONS, True),
        ("large-K", big_calls, False, WIDEST_PATH_POSITIONS, False),
        ("large-K", big_calls, True, PREFIX_POSITIONS, True))]

    # 2. the plain versions: the score kernels' and the carry calls' in
    # the card pool, B2's and the walk's here
    for n, e in enumerate(entries):
        name = e[1]
        card.submit(("main", n), card_plain_call,
                    PLAIN.get(name, name + "_plain"), to_np(e[5]))
    for n, (args, _, _) in enumerate(carry_runs):
        card.submit(("carry", n), card_plain_call,
                    "scores_pairs_chained_carry_plain", to_np(args))
    for n, r in enumerate(midk):
        for m, (args, _, _) in enumerate(r["calls"]):
            card.submit(("midk", n, m), card_plain_call,
                        PLAIN.get(r["name"], r["name"] + "_plain"),
                        to_np(args))
    for st in paths:
        path_plain(torch, report, st)

    for n, (key, name, scan, ncalls, i, args, full, out, k_ms) in \
            enumerate(entries):
        res = card.get(("main", n))
        want, p_ms = to_torch(res["out"], "cuda"), res["ms"]
        exact = all(torch.equal(a, b) for a, b in zip(out, want))
        lens = args["win_len"] if "win_len" in args else args["lengths"]
        say("main", f"{key}: {scan} scan, launch {i + 1} of {ncalls}, "
            f"Kp={args['tvecs'].shape[2]}, slots {tuple(lens.shape)}, "
            f"{int((lens > 0).sum())} windows, longest slot {full} "
            f"positions" + (f", its first {span(args)} run"
                            if span(args) < full else "")
            + f": bit-equal {exact}, kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.1f} ms (card pool)")
        check(exact, f"{key} differs from plain at the {scan} scan's shapes")
        if key == "large":
            Kp = args["tables"].shape[2]
            say("main", f"large: that launch's shape {shape_note(vk, key, Kp)}")
        record(report, key, max(max_err(torch, a, b) for a, b in zip(out, want)),
               k_ms, p_ms, span(args))
        score_bound(torch, report, key, args, out)
        say("main", f"{key}: that launch {report[key]['us_per_position']:.3f}"
            f" us/position, bound {report[key]['bound_ms']:.6f} ms "
            f"({report[key]['bound_by']})")

    exact, err, k_tot, p_tot, conts, outs = True, 0.0, 0.0, 0.0, 0, []
    for n, (args, out, k_ms) in enumerate(carry_runs):
        res = card.get(("carry", n))
        want, p_ms = to_torch(res["out"], "cuda"), res["ms"]
        ok, e = carry_equal(torch, vk, args, out, want)
        exact, err = exact and ok, max(err, e)
        k_tot, p_tot = k_tot + k_ms, p_tot + p_ms
        conts += int(args["conts"].sum())
        outs.append(out)
    say("main", f"carry: all {len(carry)} carry calls of the "
        f"DECIPHON_CHAIN_SEG=1 scan, each on its own carry-in ({conts} "
        f"continuing slots, Kp {sorted({a['tables'].shape[2] for a in carry})},"
        f" chains of <= {max(span(a) for a in carry)} positions): bit-equal "
        f"(scores and carry planes) {exact}, kernel {k_tot:.3f} ms, plain "
        f"{p_tot:.1f} ms for the calls (card pool)")
    check(exact, "carry differs from plain at the long-read shapes")
    record(report, "carry", err, k_tot, p_tot, sum(span(a) for a in carry))
    carry_bound(torch, report, {}, carry, outs)
    say("main", f"carry: {report['carry']['us_per_position']:.3f} "
        f"us/position over the calls' longest slots, bound "
        f"{report['carry']['bound_ms']:.6f} ms ({report['carry']['bound_by']})")


def carry_equal(torch, vk, args: dict, out, want) -> tuple[bool, float]:
    """One carry call against its plain version: scores bit for bit, and
    the exported planes of every slot whose planes are defined; (equal,
    largest error)."""
    exact = torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    err = max_err(torch, out[0], want[0])
    for w in range(min(args["win_len"].shape[1], vk.CW)):
        d = args["win_len"][:, w, 0] > 0  # slots with defined planes
        for a, b in ((out[2], want[2]), (out[3], want[3])):
            exact &= torch.equal(a[:, :, w][d], b[:, :, w][d])
            err = max(err, max_err(torch, a[:, :, w][d], b[:, :, w][d]))
    return exact, err


def time_midk(torch, calls: dict) -> list:
    """Phase 6, the mid-K scans' own shapes, first part: B1 (its
    DECIPHON_NO_CHAIN=1 scan) and B5 (the default route) on the launch
    with the widest lanes and then the longest slot, over its windows'
    first PREFIX_POSITIONS positions, B3 on its widest launch whole, and
    B8 on every carry call of its DECIPHON_CHAIN_SEG=1 scan at the widest
    lanes, each on its own carry-in; each run and timed alone on the card,
    each on a cluster.  Returns the runs, whose plain versions
    check_main_shapes sends to the card pool and midk_plain holds them
    against."""
    from deciphon_tpu_torch.ops import viterbi as vk

    runs = []
    for key, name, prefix in (("score", "scores_pairs", PREFIX_POSITIONS),
                              ("chain", "scores_pairs_chained", None),
                              ("gang", "scores_pairs_mixed",
                               PREFIX_POSITIONS)):
        i, args = widest(calls[name], key)
        full = span(args)
        if prefix is not None:  # each window's first `prefix` positions
            args = dict(args, lengths=args["lengths"].clamp(max=prefix))
        kernel = getattr(vk, name)
        out = kernel(**args)
        torch.cuda.synchronize()
        k_ms = cuda_ms(torch, lambda: kernel(**args), 2)
        Kp = args["tables"].shape[2]
        check(vk.SHAPES[(key, Kp)]["c"] > 1, f"{key} at Kp {Kp}: no cluster")
        runs.append(dict(key=key, name=name, i=i, ncalls=len(calls[name]),
                         full=full, calls=[(args, out, k_ms)]))
    carry = calls["scores_pairs_chained_carry"]
    check(carry, "the mid-K DECIPHON_CHAIN_SEG=1 scan made no carry launch")
    Kp = max(a["tables"].shape[2] for a in carry)
    wide = []
    for a in carry:
        if a["tables"].shape[2] == Kp:
            out = vk.scores_pairs_chained_carry(**a)
            torch.cuda.synchronize()
            wide.append((a, out, cuda_ms(
                torch, lambda: vk.scores_pairs_chained_carry(**a))))
    check(vk.SHAPES[("carry", Kp)]["c"] > 1, f"carry at Kp {Kp}: no cluster")
    runs.append(dict(key="carry", name="scores_pairs_chained_carry",
                     ncalls=len(carry), calls=wide))
    return runs


def midk_plain(torch, report, card: Side, runs: list) -> None:
    """Phase 6, the mid-K scans' own shapes, second part: each run of
    time_midk against its plain version (card pool), bit for bit (B8: the
    scores and the continuing carry planes); the kernel's and the plain
    version's times go into the kernels line under its "midk"."""
    from deciphon_tpu_torch.ops import viterbi as vk

    for n, r in enumerate(runs):
        key, exact, err, k_ms, p_ms = r["key"], True, 0.0, 0.0, 0.0
        for m, (args, out, ms) in enumerate(r["calls"]):
            res = card.get(("midk", n, m))
            want = to_torch(res["out"], "cuda")
            if key == "carry":
                ok, e = carry_equal(torch, vk, args, out, want)
            else:
                ok = all(torch.equal(a, b) for a, b in zip(out, want))
                e = max(max_err(torch, a, b) for a, b in zip(out, want))
            exact, err = exact and ok, max(err, e)
            k_ms, p_ms = k_ms + ms, p_ms + res["ms"]
        Kp = r["calls"][0][0]["tables"].shape[2]
        L = sum(span(a) for a, _, _ in r["calls"])
        report[key]["midk"] = dict(Kp=Kp, positions=L, ms=k_ms,
                                   plain_ms=p_ms, max_abs_err=err,
                                   us_per_position=k_ms * 1e3 / L,
                                   shape=vk.SHAPES[(key, Kp)])
        if key == "carry":
            what = (f"its {len(r['calls'])} carry calls at Kp={Kp} (of "
                    f"{r['ncalls']}), each on its own carry-in, longest "
                    f"slots {L} positions in all")
        else:
            what = (f"launch {r['i'] + 1} of {r['ncalls']}, Kp={Kp}, "
                    f"longest slot {r['full']} positions"
                    + (f", its first {L} run" if L < r["full"] else ""))
        say("main", f"{key}: mid-K scan, {what}: bit-equal {exact}, kernel "
            f"{k_ms:.3f} ms ({k_ms * 1e3 / L:.3f} us/position), plain "
            f"{p_ms:.1f} ms (card pool); {shape_note(vk, key, Kp)}")
        check(exact, f"{key} differs from plain at the mid-K scan's shapes")


def path_kernel(torch, scan: str, calls, narrowest: bool,
                positions: int | None, walk: bool) -> dict:
    """B2 on the widest (or narrowest), longest path launch a captured scan
    recorded, and (with `walk`) the walk of that launch's survivors as the
    scheduler launches it, each run and timed on the card; `positions`
    runs the launch's first `positions` positions only (a smaller nlb; the
    walks start from T at the last of them).  path_plain holds them
    against their plain versions."""
    from deciphon_tpu_torch.ops import traceback as tb
    from deciphon_tpu_torch.ops import viterbi as vk

    calls = calls["paths_pairs"]
    i, args = widest(calls, "path", narrowest)
    if positions is not None:
        args = dict(args, nlb=min(args["nlb"], -(-positions // vk.PATH_KAPPA)))
    kx, kd = vk.paths_pairs(**args)
    torch.cuda.synchronize()
    k_ms = cuda_ms(torch, lambda: vk.paths_pairs(**args), 1)
    st = dict(scan=scan, i=i, ncalls=len(calls), args=args, kx=kx, kd=kd,
              k_ms=k_ms, walk=None)
    if walk:
        lens = args["lengths"][..., 0].clamp(max=kx.shape[2])
        N, W = lens.shape
        Lk, Kp = kx.shape[2], args["tables"].shape[2]
        real = torch.nonzero(lens.reshape(-1) > 0)[:, 0]
        xnf, ndf = kx.reshape(N * W, Lk), kd.reshape(N * W, Lk, Kp)
        wargs = (xnf, ndf, real.to(torch.int32),
                 lens.reshape(-1)[real].contiguous(), Lk + 4 * Kp + 64)
        got = tb.walk(*wargs)
        torch.cuda.synchronize()
        st["walk"] = (wargs, got, cuda_ms(torch, lambda: tb.walk(*wargs), 3))
    return st


def path_plain(torch, report, st: dict) -> None:
    """The plain versions of a path_kernel launch and of its walks, on the
    same card tensors: bit for bit, and into the kernels line."""
    from deciphon_tpu_torch.ops import traceback as tb
    from deciphon_tpu_torch.ops import viterbi as vk

    scan, args, kx, kd, k_ms = (st[k] for k in ("scan", "args", "kx", "kd",
                                                "k_ms"))
    plain: dict = {}
    p_ms = cuda_ms(torch, lambda: plain.update(
        r=vk.paths_pairs_plain(**args)))
    px, pd = plain.pop("r")
    lens = args["lengths"][..., 0].clamp(max=kx.shape[2])
    N, W = lens.shape
    Kp = args["tables"].shape[2]
    real = torch.nonzero(lens.reshape(-1) > 0)[:, 0]
    exact, err = True, 0
    for r in real.tolist():
        n, w, L = r // W, r % W, int(lens[r // W, r % W])
        for a, b in ((kx[n, w, :L], px[n, w, :L]), (kd[n, w, :L],
                                                     pd[n, w, :L])):
            exact &= torch.equal(a, b)
            err = max(err, int((a - b).abs().max()))
    del px, pd
    run = int(lens.max())
    say("main", f"path: {scan} scan, launch {st['i'] + 1} of {st['ncalls']}"
        f", Kp={Kp}, slots {(N, W)}, {real.numel()} windows, longest "
        f"{span(args)} positions"
        + (f", its first {run} run" if run < span(args) else "")
        + f": bit-equal {exact}, kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms; "
        f"{shape_note(vk, 'path', Kp)}")
    check(exact, f"path differs from plain at the {scan} scan's shapes")
    record(report, "path", float(err), k_ms, p_ms, run)
    path_bound(torch, report, dict(args, lengths=lens[..., None]), kx)
    say("main", f"path: that launch {report['path']['us_per_position']:.3f} "
        f"us/position, bound {report['path']['bound_ms']:.6f} ms "
        f"({report['path']['bound_by']})")
    if st["walk"] is None:
        return

    # the walk of those survivors, as the scheduler launches it
    wargs, got, k_ms = st["walk"]
    steps, lt = wargs[4], wargs[3]
    plain = {}
    p_ms = cuda_ms(torch, lambda: plain.update(r=tb.walk_plain(*wargs)))
    exact = all(torch.equal(a, b) for a, b in zip(got, plain["r"]))
    check(exact and bool(got[3].all()),
          f"walk differs at the {scan} scan's shapes")
    record(report, "walk", 0.0, k_ms, p_ms, int(lt.max()))
    walk_bound(report, got[2])
    # per scan: a launch's walks run side by side, so its time is the
    # longest walk's chain of steps
    longest = int(got[2].max())
    w = report["walk"]
    w.setdefault("scans", {})[scan] = dict(
        walks=real.numel(), steps=int(got[2].sum()), longest=longest,
        ms=k_ms, ns_per_step=k_ms * 1e6 / longest, plain_ms=p_ms,
        bound_ms=w["bound_ms"], bound_by=w["bound_by"])
    say("main", f"walk: the {real.numel()} walks of that trellis, "
        f"max_steps {steps}: all ok {bool(got[3].all())}, bit-equal "
        f"{exact}, kernel {k_ms:.3f} ms ({k_ms * 1e6 / longest:.1f} ns a "
        f"step of the longest walk, {longest} steps; "
        f"{int(got[2].sum())} steps in all), plain {p_ms:.1f} ms, bound "
        f"{w['bound_ms']:.6f} ms ({w['bound_by']})")


class Scans:
    """Scans of one database on the card: walls, products and the launch
    counts of each main-path run."""

    def __init__(self, torch, profiles, seqs, phase: str, scorer=None,
                 confirmer=None, engine: str = "kernels"):
        from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner

        self.torch, self.seqs, self.phase = torch, seqs, phase
        self.scanner = Scanner(profiles, ScanConfig(device="cuda",
                                                    engine=engine),
                               confirmer=confirmer, scorer=scorer)
        self.peaks: list[float] = []  # GiB, per counted scan
        self.counts: dict = {}  # launches of the last counted scan
        self.uploads: dict = {}  # table uploads of the last counted scan
        # (launches, table uploads) of the counted scan under each
        # environment, by its sorted items
        self.by_env: dict = {}
        self.htod_s = 0.0  # host-to-device copy seconds, profiled scan
        self.dev_s: dict = {}  # device seconds by kernel, profiled scan

    def scan(self, scanner=None):
        sc = scanner or self.scanner
        with tempfile.TemporaryDirectory() as tmp:
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = sc.run(self.seqs, os.path.join(tmp, "prod"))
            self.torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(path) as fp:
                return wall, fp.read().splitlines()

    def counted(self, launches: dict, need: tuple, env: dict | None = None):
        """One main-path scan with the launch counts set to 0 just before
        and read just after; every kernel in `need` must have launched.
        The counts are added to `launches`."""
        from deciphon_tpu_torch.ops import traceback as tb
        from deciphon_tpu_torch.ops import viterbi as vk
        from deciphon_tpu_torch.scan import scheduler as ts

        with environ(env or {}):
            self.torch.cuda.reset_peak_memory_stats()
            vk.reset_launches()
            ts.reset_uploads()
            tb.REWALKS["survivors"] = 0
            wall, lines = self.scan()
            counts, rewalks = dict(vk.LAUNCHES), tb.REWALKS["survivors"]
        m = self.scanner.metrics
        peak = self.torch.cuda.max_memory_allocated()
        self.peaks.append(peak / 2**30)
        self.counts, self.uploads = counts, dict(ts.UPLOADS)
        self.by_env[tuple(sorted((env or {}).items()))] = (counts,
                                                           self.uploads)
        tag = " ".join(f"{k}={v}" for k, v in (env or {}).items()) or \
            "default tiers"
        say(self.phase, f"{tag}: wall {wall:.6f} s, "
            f"{len(self.seqs) / wall:.6f} reads/s, "
            f"{m.cells / wall / 1e9:.6f} GCUPS ({m.cells} true cells), "
            f"windows {m.windows_scored}, survivors {m.survivors}, "
            f"products {m.products}, peak {peak / 2**30:.3f} GiB; launches "
            f"{counts}, table uploads {self.uploads}, walks re-walked "
            f"{rewalks}; walls " + json.dumps(
                {k: round(v, 4) for k, v in sorted(m.walls.items())}))
        for k in need:
            check(counts[k] > 0, f"kernel {k} never launched on the "
                  f"{self.phase} path ({tag})")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        check(rewalks == 0, "a walk overflowed its first max_steps")
        check(m.survivors > 0, "no LRT survivors")
        check(len(lines) == m.products + 1, "products.tsv lacks lines")
        check(m.products > 0 or self.scanner.confirmer is not None,
              "no products written")
        for ln in lines[1:]:
            cols = ln.split("\t")
            check(len(cols) == 12 and cols[7].startswith("SAMPLE"),
                  f"malformed product line {ln[:80]!r}")
        return wall, lines

    def captured(self, lines, env: dict | None = None) -> dict:
        """One more scan, outside every counted run, that records the
        arguments of each kernel wrapper's calls: {wrapper: [kwargs]}.
        It must write `lines` again."""
        from deciphon_tpu_torch.ops import viterbi as vk

        calls = {n: [] for n in SPIED}
        orig = {n: getattr(vk, n) for n in SPIED}

        def spy(name):
            sig = inspect.signature(orig[name])

            def wrapper(*args, **kwargs):
                calls[name].append(dict(sig.bind(*args, **kwargs).arguments))
                return orig[name](*args, **kwargs)
            return wrapper

        try:
            for n in SPIED:
                setattr(vk, n, spy(n))
            with environ(env or {}):
                _, again = self.scan()
        finally:
            for n, f in orig.items():
                setattr(vk, n, f)
        check(again == lines, "the captured scan wrote other products")
        return calls

    def ledger(self, lines, env: dict | None = None, shards: int = 1,
               one_device: dict | None = None) -> dict:
        """One more scan, outside every counted run and warm median, with
        the bucket ledgers on (LEDGER_SWITCHES, and `env`): it must write
        `lines`, launch what the counted scan under `env` launched and
        upload its table bytes; its ledger must hold one entry a phase-1
        dispatch (`shards` launches an entry; the large-K tier's one), a
        wall for every name, one FILL line a chain or carry entry, and,
        given `one_device` (a one-device scan's ledger), its names and
        cells.  Prints each bucket's wall, true and padded cells, fill and
        count, the FILL lines, and the share of the scan's wall in the
        bkt_ walls.  Returns {name: (true, padded, count)}."""
        from deciphon_tpu_torch.ops import viterbi as vk
        from deciphon_tpu_torch.scan import scheduler as ts

        env = env or {}
        tag = " ".join(f"{k}={v}" for k, v in env.items()) or \
            "default tiers"
        buf = io.StringIO()
        with environ({**env, **LEDGER_SWITCHES}):
            vk.reset_launches()
            ts.reset_uploads()
            with contextlib.redirect_stdout(buf):
                wall, again = self.scan()
            counts, uploads = dict(vk.LAUNCHES), dict(ts.UPLOADS)
        out = buf.getvalue().splitlines()
        for ln in out:
            if not ln.startswith("FILL "):
                print(ln, flush=True)
        fills = [ln for ln in out if ln.startswith("FILL ")]
        m = self.scanner.metrics
        cells = dict(m.bucket_cells)
        check(again == lines, f"{self.phase}, ledger scan ({tag}): other "
              "products than the phase's own")
        want, want_up = self.by_env[tuple(sorted(env.items()))]
        check(counts == want, f"{self.phase}, ledger scan ({tag}): launches "
              f"{counts} differ from the counted scan's {want}")
        check(uploads == want_up, f"{self.phase}, ledger scan ({tag}): table "
              f"uploads {uploads} differ from the counted scan's {want_up}")
        entries: dict[str, int] = {}
        for name, (_, _, n) in cells.items():
            k = bucket_kernel(name)
            entries[k] = entries.get(k, 0) + n
        phase1 = {k: counts[k] for k in BUCKET_PREFIXES if counts[k]}
        per = {k: (1 if k == "large" else shards) * n
               for k, n in entries.items()}
        check(cells and per == phase1, f"{self.phase}, ledger scan ({tag}): "
              f"entries by kernel {entries} (x {shards} shards) are not the "
              f"scan's phase-1 launches {phase1}")
        check(set(cells) <= set(m.walls), f"{self.phase}, ledger scan "
              f"({tag}): a bucket has no wall")
        check(len(fills) == entries.get("chain", 0) + entries.get("carry", 0),
              f"{self.phase}, ledger scan ({tag}): {len(fills)} FILL lines "
              "for the chain and carry entries")
        bkt = sum(m.walls[n] for n in cells)
        say(self.phase, f"ledger scan ({tag}): wall {wall:.6f} s, bkt_ walls "
            f"{bkt:.6f} s, {bkt / wall:.6f} of the scan's wall; "
            f"{sum(entries.values())} entries, by kernel {entries}, "
            f"launches {phase1} ({shards} shard(s)); products, launches and "
            "table uploads those of the counted scan")
        for name in sorted(cells):
            t, pad, n = cells[name]
            say(self.phase, f"  {name}: wall {m.walls[name]:.6f} s, true "
                f"{t}, padded {pad}, fill {t / pad:.6f}, count {n}")
        for ln in fills:
            say(self.phase, f"  {ln}")
        if one_device is not None:
            check(cells == one_device, f"{self.phase}, ledger scan ({tag}): "
                  "names or cells differ from the one-device scan's")
            say(self.phase, f"ledger scan ({tag}): names and cells equal to "
                "the one-device scan's")
        return cells

    def warm_and_profile(self, lines, n_warm: int = 3) -> float:
        """`n_warm` warm scans (their median wall) and one profiled
        scan."""
        warm = []
        for _ in range(n_warm):
            w, again = self.scan()
            check(again == lines, "a warm scan wrote other products")
            warm.append(w)
        med = statistics.median(warm)
        m = self.scanner.metrics
        say(self.phase, f"warm walls {warm} s; median {med:.6f} s, "
            f"{len(self.seqs) / med:.6f} reads/s, "
            f"{m.cells / med / 1e9:.6f} GCUPS; last warm walls "
            + json.dumps({k: round(v, 4) for k, v in sorted(m.walls.items())}))

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_wall, _ = self.scan()
        dev_s: dict[str, float] = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
            if us > 0:
                dev_s[evt.key[:64]] = dev_s.get(evt.key[:64], 0.0) + us / 1e6
        self.dev_s = dev_s
        busy = sum(dev_s.values())
        top = dict(sorted(dev_s.items(), key=lambda kv: -kv[1])[:8])
        self.htod_s = sum(v for k, v in dev_s.items() if "HtoD" in k)
        walk_s = sum(v for k, v in dev_s.items() if "walk_kernel" in k)
        say(self.phase, f"profiled scan: wall {prof_wall:.6f} s, device busy "
            f"{busy:.6f} s, idle share {max(0.0, 1 - busy / prof_wall):.6f}, "
            f"host-to-device copies {self.htod_s:.6f} s, walk "
            f"{walk_s:.6f} s; "
            "device s by kernel " + json.dumps(top))
        return med


def ledger_line(scorer) -> str:
    """The capacity ledger's plan: (kind, Kp, GB) of the resident and of
    the streamed scorers."""
    def rows(plan):
        return [(type(scorer.scorers[i]).__name__, scorer.scorers[i].Kp,
                 round(b / 1e9, 6)) for i, b in plan]
    led = scorer.ledger
    return (f"budget {led.budget / 1e9:.6f} GB; resident "
            f"{led.resident_bytes / 1e9:.6f} GB {rows(led.resident)}; "
            f"streamed {led.streamed_bytes / 1e9:.6f} GB "
            f"{rows(led.streamed)}")


def stream_scans(torch, report, launches: dict, pfam, lr, lines,
                 long_lines, resident_med: float, long_med: float) -> None:
    """Phase 5c, the streamed-table tier: the Pfam scan with the table
    budget at half its table bytes (first scan counted, three warm, one
    profiled), then the long-read scan with a budget of 1 byte (counted,
    one warm, one profiled; its gang must run B4m and never B5), each
    writing its resident scan's bytes and set beside its resident warm
    median; B4m against B5 on every gang launch of the streamed long-read
    scan, and against its plain version on the widest of them, bit for
    bit; the peak allocation of the resident and streamed scans."""
    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.scan.scheduler import BucketedPairScorer

    profiles = pfam.scanner.profiles
    tbytes = sum(s.table_bytes() for s in pfam.scanner.scorer.scorers)
    budget = tbytes // 2
    t0 = time.perf_counter()
    sp = Scans(torch, profiles, pfam.seqs, "stream", scorer=lambda c:
               BucketedPairScorer(c, "cuda", hbm_budget=budget))
    led = sp.scanner.scorer.ledger
    say("stream", f"Pfam, {tbytes / 1e9:.6f} GB of tables: "
        f"{ledger_line(sp.scanner.scorer)}; host set-up "
        f"{time.perf_counter() - t0:.1f} s")
    check(led.streamed and led.resident,
          "the half budget left no scorer streamed or none resident")
    first, s_lines = sp.counted(launches, ("pchain", "chain", "path", "walk"))
    check(s_lines == lines, "the streamed Pfam scan wrote other products "
          "than the resident scan")
    up = sp.uploads
    med = sp.warm_and_profile(lines)
    say("stream", f"Pfam streamed: first scan {first:.6f} s, warm median "
        f"{med:.6f} s against the resident median {resident_med:.6f} s "
        f"({med / resident_med:.3f}x); per scan {up['uploads']} table "
        f"uploads ({up['phase2']} for phase 2), {up['bytes'] / 1e9:.6f} "
        f"GB, host-to-device copies {sp.htod_s:.6f} s of device time in the "
        f"profiled scan; products byte-identical")
    peak_pfam = sp.peaks[0]
    del sp

    t0 = time.perf_counter()
    sl = Scans(torch, profiles, lr.seqs, "stream-long", scorer=lambda c:
               BucketedPairScorer(c, "cuda", hbm_budget=1))
    say("stream", f"long read: {ledger_line(sl.scanner.scorer)}; host "
        f"set-up {time.perf_counter() - t0:.1f} s")
    check(not sl.scanner.scorer.ledger.resident, "a scorer stayed resident")
    wall, s_long = sl.counted(launches, ("pchain", "chain", "gang_large",
                                         "path", "walk"))
    check(sl.counts["gang"] == 0, "the streamed long-read scan ran B5")
    check(s_long == long_lines, "the streamed long-read scan wrote other "
          "products than the resident scan")
    up = sl.uploads
    s_med = sl.warm_and_profile(s_long, n_warm=1)
    say("stream", f"long read streamed: first scan {wall:.6f} s, warm "
        f"{s_med:.6f} s against the resident warm scan {long_med:.6f} s "
        f"({s_med / long_med:.3f}x); per scan {up['uploads']} table uploads "
        f"({up['phase2']} for phase 2), {up['bytes'] / 1e9:.6f} GB, "
        f"host-to-device copies {sl.htod_s:.6f} s of device time in the "
        "profiled scan; products byte-identical")
    calls = sl.captured(s_long)["scores_pairs_mixed_large"]
    check(calls, "the captured streamed scan made no B4m launch")
    exact, k_tot, b_tot = True, 0.0, 0.0
    for args in calls:
        ka, kn = vk.scores_pairs_mixed_large(**args)
        ba, bn = vk.scores_pairs_mixed(**args)
        exact &= torch.equal(ka, ba) and torch.equal(kn, bn)
        k_tot += cuda_ms(torch, lambda: vk.scores_pairs_mixed_large(**args))
        b_tot += cuda_ms(torch, lambda: vk.scores_pairs_mixed(**args))
    shapes = sorted({(tuple(a["pidx"].shape), a["tables"].shape[2])
                     for a in calls})
    say("stream", f"B4m against B5 on the {len(calls)} gang launches of the "
        f"streamed long-read scan ((N, W), Kp {shapes}, slots of <= "
        f"{max(span(a) for a in calls)} positions): bit-equal {exact}; B4m "
        f"{k_tot:.3f} ms, B5 {b_tot:.3f} ms for the launches")
    check(exact, "B4m differs from B5 at the streamed scan's shapes")
    i, args = widest(calls, "gang_large")
    out, want, k_ms, p_ms = kernel_vs_plain(
        torch, vk.scores_pairs_mixed_large, vk.scores_pairs_mixed_plain,
        args, reps=1)
    exact = all(torch.equal(a, b) for a, b in zip(out, want))
    say("stream", f"B4m against its plain version on the widest gang launch "
        f"of the streamed long-read scan (launch {i + 1} of {len(calls)}, "
        f"Kp {args['tables'].shape[2]}, slots {tuple(args['pidx'].shape)}, "
        f"{int((args['lengths'] > 0).sum())} windows, longest slot "
        f"{span(args)} positions): bit-equal {exact}, kernel {k_ms:.3f} ms, "
        f"plain {p_ms:.1f} ms")
    check(exact, "B4m differs from plain at the streamed scan's shapes")
    record(report, "gang_large",
           max(max_err(torch, a, b) for a, b in zip(out, want)), k_ms, p_ms,
           span(args))
    score_bound(torch, report, "gang_large", args, out)
    sl.ledger(s_long)
    peak_long = sl.peaks[0]
    del sl, calls
    say("stream", f"peak allocation, GiB: Pfam resident {pfam.peaks[0]:.3f}, "
        f"streamed {peak_pfam:.3f}; long read resident {lr.peaks[0]:.3f}, "
        f"streamed {peak_long:.3f}")


def largek_scan(torch, launches: dict, data):
    """The large-K scan of `data` (`workload.pfam_largek()`'s profiles and
    reads): every bucket past Kp 5120 on B4, survivors on B2 and the walk;
    first scan (counted), three warm scans and one profiled.  Returns (its
    Scans, its product lines)."""
    big_prof, big_seqs = data
    big = Scans(torch, big_prof, big_seqs, "largek")
    bscorers = big.scanner.scorer.scorers
    check(all(getattr(s, "hbm_table", False) for s in bscorers),
          "a large-K profile left the large-K tier")
    say("largek", f"{len(bscorers)} large-K scorers (Kp, w, profiles) "
        f"{[(s.Kp, s.w, len(s.tables)) for s in bscorers]}; "
        f"{sum(s.table_bytes() for s in bscorers) / 1e9:.3f} GB of tables "
        "on the card")
    first, big_lines = big.counted(launches, ("large", "path", "walk"))
    say("largek", f"first scan of these tables (cold): {first:.6f} s")
    from deciphon_tpu_torch.ops import viterbi as vk

    for (key, Kp), _ in sorted(vk.SHAPES.items()):
        if key in ("large", "path") and Kp in {s.Kp for s in bscorers}:
            say("largek", f"{key} at Kp {Kp}: {shape_note(vk, key, Kp)}")
        check(key not in ("large", "path") or Kp not in {
            s.Kp for s in bscorers} or vk.SHAPES[(key, Kp)]["c"] > 1,
            f"{key} at Kp {Kp} did not run on a cluster")
    hit_reads = {int(ln.split("\t")[0]) for ln in big_lines[1:]}
    say("largek", f"products on reads {sorted(hit_reads)}")
    check({0, 1, 2} <= hit_reads, "no products on a planted large-K read")
    big.warm_and_profile(big_lines)
    return big, big_lines


def torch_engine_subset(torch, profiles, seqs, want: str,
                        launches: dict) -> None:
    """Phase 7, the torch engine: Scanner(ScanConfig(engine="torch")) on
    the card on the subset, with the launch counts set to 0 just before
    and read just after: the lax.scan engine's counterpart scores in plain
    PyTorch and its phase 2 walks on the card, so the walk is the one
    kernel of this path.  Its bytes must be the kernels' (`want`).  The
    walk's calls in that run are recorded, and the one on the largest
    trellis (viterbi_path_batch's planes, row 0 dropped, K lanes) is held
    against the plain walk on the same card tensors, bit for bit."""
    from deciphon_tpu_torch.ops import traceback as tb
    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.scan import scheduler as sched
    from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner

    sc = Scanner(profiles, ScanConfig(device="cuda", engine="torch"))
    check(isinstance(sc.scorer, sched.TorchPairScorer) and
          sc.scorer.device.type == "cuda", "engine='torch' left the card")
    walks, orig = [], sched.walk
    sig = inspect.signature(orig)

    def spy(*args, **kwargs):
        walks.append(dict(sig.bind(*args, **kwargs).arguments))
        return orig(*args, **kwargs)

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        vk.reset_launches()
        tb.REWALKS["survivors"] = 0
        sched.walk = spy
        try:
            t0 = time.perf_counter()
            path = sc.run(seqs, os.path.join(tmp, "p"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            sched.walk = orig
        counts = dict(vk.LAUNCHES)
        with open(path) as fp:
            got = fp.read()
    m = sc.metrics
    say("subset", f"engine='torch', cuda: {len(profiles)} profiles x "
        f"{len(seqs)} reads of {seqs[0].size} nt, wall {wall:.6f} s, "
        f"windows {m.windows_scored}, survivors {m.survivors}, products "
        f"{m.products}; launches {counts}, walks re-walked "
        f"{tb.REWALKS['survivors']}; walls " + json.dumps(
            {k: round(v, 4) for k, v in sorted(m.walls.items())}))
    check(counts["walk"] > 0, "engine='torch' launched no walk")
    check(sum(counts.values()) == counts["walk"],
          "engine='torch' launched a score or path kernel")
    check(got == want, "engine='torch' on the card wrote other products "
          "than the kernels")
    launches["walk"] = launches.get("walk", 0) + counts["walk"]

    check(len(walks) == counts["walk"], "a walk launch was not recorded")
    i = max(range(len(walks)), key=lambda j: walks[j]["nd"].numel())
    a = walks[i]
    k_out = tb.walk(**a)
    p_out = tb.walk_plain(**a)
    exact = all(torch.equal(x, y) for x, y in zip(k_out, p_out))
    R, Lk, K = a["nd"].shape
    say("subset", f"engine='torch' walk: launch {i + 1} of {len(walks)}, "
        f"trellis ({R}, {Lk}, {K}), {a['rows'].numel()} walks, max_steps "
        f"{a['max_steps']}: all ok {bool(k_out[3].all())}, bit-equal to the "
        f"plain walk {exact}")
    check(exact and bool(k_out[3].all()),
          "engine='torch': the walk differs from its plain version")


def amino_bound_ms(key: str, a: dict, ks: list) -> tuple[float, str]:
    """(bound ms, what bounds it) of the amino kernel `key` on the call `a`
    (hits of true sizes `ks`): AMINO_OPS[key] operations a (position, true
    node) cell of every hit, and the bytes of the inputs (odds tables,
    vectors, residues, offsets, specials) and of the outputs, each once
    (the kernel's scratch is its own traffic, not the function's)."""
    lens = (a["off"][1:] - a["off"][:-1]).tolist()
    cells = sum(n * k for n, k in zip(lens, ks))
    H, _, Kpad = a["em"].shape
    out = H * 4 * (1 if key == "amino_forward" else 3 + Kpad)
    byts = nbytes(*(a[k] for k in ("em", "tv", "res", "off", "xv"))) + out
    t_ops, t_bytes = cells * AMINO_OPS[key] / PEAK_F32_OPS, byts / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def amino_bound(report, key: str, a: dict, ks: list) -> None:
    b, by = amino_bound_ms(key, a, ks)
    report[key].update(bound_ms=b, bound_by=by, library_ms=None)


def amino_err(torch, got, want, LN2: float):
    """(max |got - want| with scores in bits, within rtol 1e-4 and atol
    1e-3): the reference's own tolerance against brute force.  Column 0 of
    a posterior row, and a Forward output, are nats."""
    scale = torch.ones_like(want)
    if want.dim() == 1:
        scale /= LN2
    else:
        scale[:, 0] = 1 / LN2
    g, w = got * scale, want * scale
    ok = bool(torch.isfinite(g).all()) and bool(
        ((g - w).abs() <= 1e-3 + 1e-4 * w.abs()).all())
    return float((g - w).abs().max()), ok


def exact(plain, args: dict):
    """A plain version on the f64 copy of the kernel's arguments: the same
    function without the f32 rounding that log space accumulates over a
    long hit (the yardstick the odds-space kernels are held to)."""
    return plain(**{k: v.double() if v.is_floating_point() else v
                    for k, v in args.items()}).float()


def amino_vs_plain(torch, report, args: dict, ks: list, what: str,
                   reps: int = 3) -> None:
    """Both amino kernels against their plain versions on the same card
    tensors (a batch of hits of one Kpad): the error against the plain
    version evaluated in f64 (beside the f32 plain version's own), the
    kernel's and the f32 plain version's times and the bound go into the
    kernels line (a position's time: kernel ms over the longest hit's
    positions)."""
    from deciphon_tpu_torch.hmmer import forward as hf

    lens = (args["off"][1:] - args["off"][:-1]).tolist()
    Kpad = args["em"].shape[2]
    for key, kern, plain in (
            ("amino_forward", hf.amino_forward, hf.amino_forward_plain),
            ("amino_posterior", hf.amino_posterior,
             hf.amino_posterior_plain)):
        out, p32, k_ms, p_ms = kernel_vs_plain(torch, kern, plain, args,
                                               reps=reps)
        want = exact(plain, args)
        err, ok = amino_err(torch, out, want, hf.LN2)
        drift, _ = amino_err(torch, p32, want, hf.LN2)
        extra = ""
        if key == "amino_posterior":
            tot = out[:, 1:].double().sum(1).tolist()
            extra = f", usages sum to {[round(t, 4) for t in tot]}"
        say("confirm", f"{key}: {what}, Kpad {Kpad}, {len(lens)} hits of L "
            f"{lens} (K {ks}): max error {err:.3e} against the plain "
            f"version in f64 (scores in bits), within rtol 1e-4 atol 1e-3 "
            f"{ok} (the f32 plain version's own {drift:.3e}){extra}; kernel "
            f"{k_ms:.3f} ms, plain {p_ms:.1f} ms")
        check(ok, f"{key} differs from plain ({what}, Kpad {Kpad})")
        record(report, key, err, k_ms, p_ms, max(lens))
        amino_bound(report, key, args, ks)
        say("confirm", f"{key}: {report[key]['us_per_position']:.3f} us a "
            f"position, bound {report[key]['bound_ms']:.6f} ms "
            f"({report[key]['bound_by']})")


def check_amino(torch, report) -> None:
    """Both amino kernels against their plain versions at AMINO_KPADS:
    hits of L 1 (and 37, 300; at Kpad 16384 one of 40) with 'X' residues,
    a batch of hits a launch; and each batch's rows bit-equal to its hits
    launched one at a time."""
    from deciphon_tpu_torch.hmmer import forward as hf
    from deciphon_tpu_torch.workload import amino_hits

    for Kpad in AMINO_KPADS:
        lens = [1, 37, 300] if Kpad <= 2048 else [1, 40]
        c = amino_hits(Kpad, lens, Kpad + 17, "cuda")
        check(any("X" in q for q in c["seqs"]), "no degenerate residue")
        args = {k: c[k] for k in ("em", "tv", "res", "off", "xv")}
        amino_vs_plain(torch, report, args, c["ks"], "synthetic hits",
                       reps=2)
        off = args["off"].tolist()
        for fn in (hf.amino_forward, hf.amino_posterior):
            batch = fn(**args)
            for h in range(len(lens)):
                one = fn(em=args["em"][h:h + 1], tv=args["tv"][h:h + 1],
                         res=args["res"][off[h]:off[h + 1]].contiguous(),
                         off=torch.tensor([0, lens[h]], dtype=torch.int32,
                                          device="cuda"),
                         xv=args["xv"][h:h + 1])
                check(torch.equal(batch[h:h + 1], one),
                      f"{fn.__name__}: Kpad {Kpad} hit {h} of a batch is "
                      "not its launch alone")
        say("confirm", f"Kpad {Kpad}: a batch of {len(lens)} hits of L "
            f"{lens} bit-equal to each launched alone (both kernels)")


class Recorder:
    """A confirmer that records (p_idx, amino string, logevalue) and each
    hit's (Forward nats, null2 bias nats) (None for an empty string or
    without null2); a wave's hits go to `confirm_many` at once (`waves`
    keeps each call's hits), or, with `single`, through `__call__` one at
    a time (the pipeline's hit-by-hit route)."""

    def __init__(self, conf, single: bool = False):
        self.conf, self.calls, self.parts, self.waves = conf, [], [], []
        self._pending = []
        bias = conf.scorer.null2_bias_nats

        def spy(p_idx, amino_seq, usages=None):
            b = bias(p_idx, amino_seq, usages)
            self._pending.append((usages[0], b))
            return b
        conf.scorer.null2_bias_nats = spy
        if not single:
            self.confirm_many = self._many

    def _many(self, hits):
        self._pending = []
        out = self.conf.confirm_many(hits)
        self.waves.append(list(hits))
        for (p, q), o in zip(hits, out):
            self.calls.append((p, q, o[0]))
            self.parts.append(self._pending.pop(0)
                              if q and self._pending else None)
        return out

    def __call__(self, p_idx, amino_seq):
        self._pending = []
        out = self.conf.confirm(p_idx, amino_seq)
        self.calls.append((p_idx, amino_seq, out[0]))
        self.parts.append(self._pending[0] if self._pending else None)
        return out

    def groups(self, posterior: bool = True) -> int:
        """The launches of the batched route, summed over the waves: a
        launch a Kpad group of the wave's non-empty hits (a posterior
        group past the scratch budget in more, which no scan here
        reaches)."""
        plan = self.conf.scorer.launch_plan
        return sum(len(plan([h for h in w if h[1]], posterior))
                   for w in self.waves)


def strip_evalue(line: str) -> str:
    cols = line.split("\t")
    return "\t".join(cols[:10] + cols[11:])


def product_dir(root: str) -> dict:
    """{relative path: bytes} of a product directory."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fp:
                out[os.path.relpath(path, root)] = fp.read()
    return out


def confirmed_close(hmms, a: Recorder, b: Recorder) -> float:
    """Two recorders of the same scan, `b` the plain versions in f64: the
    same calls and keep decisions, Forward and null2 nats within rtol 1e-4
    and atol 1e-3, log-E within the tolerance they carry (atol 1e-3 + rtol
    1e-4 (|fwd| + |bias|) lambda / ln 2).  Returns that tolerance's
    largest value over the kept hits, in bits."""
    from deciphon_tpu_torch.hmmer.forward import LN2

    check([c[:2] for c in a.calls] == [c[:2] for c in b.calls],
          "the confirmer saw other hits")
    check([c[2] < 0 for c in a.calls] == [c[2] < 0 for c in b.calls],
          "the confirmer kept other hits")
    widest = 1e-3
    for x, y, px, py in zip(a.calls, b.calls, a.parts, b.parts):
        if px is None or py is None:
            check(px is None and py is None and x[2] == y[2] == 0.0,
                  "an empty hit was confirmed")
            continue
        check(all(abs(u - v) <= 1e-3 + 1e-4 * abs(v)
                  for u, v in zip(px, py)), "Forward or null2 nats differ")
        bits = 1e-3 + 1e-4 * (abs(py[0]) + abs(py[1])) / LN2
        lam = hmms[x[0]].stats["FORWARD"][1]
        check(abs(x[2] - y[2]) <= lam * bits, f"log-E {x[2]} against {y[2]}")
        if x[2] < 0:
            widest = max(widest, bits, lam * bits)
    return widest


def drift(a: Recorder, b: Recorder) -> str:
    """The largest differences of Forward nats, null2 bias nats and log-E
    between two recorders of the same scan."""
    d = [0.0, 0.0, 0.0]
    for x, y, px, py in zip(a.calls, b.calls, a.parts, b.parts):
        d[2] = max(d[2], abs(x[2] - y[2]))
        if px is not None and py is not None:
            d[0] = max(d[0], abs(px[0] - py[0]))
            d[1] = max(d[1], abs(px[1] - py[1]))
    return f"Forward {d[0]:.3e}, null2 bias {d[1]:.3e}, log-E {d[2]:.3e}"


def blobs_close(a: bytes, b: bytes, atol: float) -> bool:
    from deciphon_tpu_torch.hmmer.h3result import H3Result

    ha, hb = H3Result.from_blob(a), H3Result.from_blob(b)
    if vars(ha.stats) != vars(hb.stats) or len(ha.hits) != len(hb.hits):
        return False
    for x, y in zip(ha.hits, hb.hits):
        for k, u in vars(x).items():
            v = getattr(y, k)
            if isinstance(u, float):
                if abs(u - v) > atol + 1e-4 * abs(v):
                    return False
            elif k != "domains" and u != v:
                return False
    return True


def confirm_inputs(label: str, sub=None, hmms=None):
    """(profiles, reads, HMMs) of a confirmed subset scan: the Pfam
    subset (the side pool draws it and the HMMs anew: the same as the
    card's) or `confirm_case`."""
    from deciphon_tpu_torch.workload import (confirm_case, pfam_scan_hmms,
                                             pfam_subset)

    if label == "confirm_case":
        c_hmms, c_prof, c_seqs = confirm_case()
        return c_prof, c_seqs, c_hmms
    sub_prof, sub_seqs = sub if sub is not None else pfam_subset()
    by_acc = {h.accession: h for h in (hmms or pfam_scan_hmms())}
    return sub_prof, sub_seqs, [by_acc[p.accession] for p in sub_prof]


def confirm_subset_run(label: str, run: str, conf_inputs=None) -> dict:
    """One confirmed scan of confirm_subsets: `run` "card" (NativeConfirmer
    on the card), "cpu" (the plain versions in f32) or "cpu f64"
    (`exact_confirmer`), the two CPU runs in the side pool.  Returns the
    product files, the recorder's calls, parts and waves, and counts."""
    from types import SimpleNamespace

    from deciphon_tpu_torch.hmmer.forward import NativeConfirmer
    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner
    from deciphon_tpu_torch.workload import exact_confirmer

    prof, seqs, hm = conf_inputs or confirm_inputs(label)
    dev = "cuda" if run == "card" else "cpu"
    t0 = time.perf_counter()
    rec = Recorder(NativeConfirmer(hm, device=dev) if run != "cpu f64"
                   else exact_confirmer(hm))
    vk.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        sc = Scanner(prof, ScanConfig(device=dev), confirmer=rec)
        sc.run(seqs, os.path.join(tmp, "p"))
        outs = product_dir(os.path.join(tmp, "p"))
    out = dict(outs=outs, products=sc.metrics.products,
               seconds=time.perf_counter() - t0, launches=dict(vk.LAUNCHES),
               n_prof=len(prof), n_seqs=len(seqs), size=seqs[0].size,
               rec=SimpleNamespace(
                   calls=[(p, q, float(e)) for p, q, e in rec.calls],
                   parts=[None if x is None else tuple(map(float, x))
                          for x in rec.parts],
                   waves=rec.waves))
    if run == "card":
        out["groups"] = rec.groups()
    return out


def confirm_subsets(torch, sub_prof, sub_seqs, hmms, side: Side) -> None:
    """The confirmed scan on the card and on the CPU (NativeConfirmer on
    each; on the CPU the plain versions in f32, and in f64, run in the
    side pool): the Pfam subset (12 profiles, two reads of 1.2 knt) and
    `confirm_case` (peaked profiles whose hits are kept and dropped).  The
    same hits confirmed, kept and dropped; every products.tsv column but
    the e-value byte-identical; Forward and null2 nats and log-E of the
    card within tolerance of the f64 run (confirmed_close), and the same
    h3r files with close fields; the f32 run's own distance from the f64
    run printed; on the card one posterior launch a (wave, Kpad) group; on
    confirm_case the confirmed lines are the unconfirmed scan's lines
    that were kept."""
    from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner

    for label in ("Pfam subset", "confirm_case"):
        inputs = confirm_inputs(label, (sub_prof, sub_seqs), hmms)
        prof, seqs, hm = inputs
        runs = {"card": confirm_subset_run(label, "card", inputs)}
        for run in ("cpu", "cpu f64"):
            runs[run] = side_result(side, ("confirm", label, run))
        outs = {run: r["outs"] for run, r in runs.items()}
        recs = {run: r["rec"] for run, r in runs.items()}
        for run, r in runs.items():
            rec = r["rec"]
            kept = sum(c[2] < 0 for c in rec.calls)
            say("subset", f"confirmed, {label}, {run}: {r['n_prof']} "
                f"profiles x {r['n_seqs']} reads of {r['size']} nt, "
                f"{len(rec.calls)} hits confirmed in {len(rec.waves)} "
                f"calls, {kept} kept, {len(rec.calls) - kept} dropped, "
                f"{r['products']} products, {r['seconds']:.3f} s"
                + ("" if run == "card" else " (side pool)")
                + f"; launches {r['launches']}")
        check(runs["card"]["launches"]["amino_posterior"]
              == runs["card"]["groups"] > 0,
              f"{label}: not one launch a (wave, Kpad) group")
        check(all(sum(runs[run]["launches"].values()) == 0
                  for run in ("cpu", "cpu f64")),
              f"{label}: a CPU run launched a kernel")
        widest = confirmed_close(hm, recs["card"], recs["cpu f64"])
        check([c[2] < 0 for c in recs["cpu"].calls]
              == [c[2] < 0 for c in recs["card"].calls],
              f"{label}: card and CPU kept other hits")
        g = outs["card"]
        tg = g["products.tsv"].decode().splitlines()
        for run in ("cpu", "cpu f64"):
            w = outs[run]
            check(g.keys() == w.keys(), f"{label}: other product files")
            tw = w["products.tsv"].decode().splitlines()
            check([strip_evalue(x) for x in tg]
                  == [strip_evalue(x) for x in tw],
                  f"{label}: card and {run} products differ")
        check(all(blobs_close(g[k], outs["cpu f64"][k], widest) for k in g
                  if k.endswith(".h3r")), f"{label}: h3r fields differ")
        kept = sum(c[2] < 0 for c in recs["card"].calls)
        check(len(tg) - 1 == kept, f"{label}: a kept hit was not written")
        if label == "confirm_case":
            check(0 < kept < len(recs["card"].calls),
                  "confirm_case: no hit kept, or none dropped")
            with tempfile.TemporaryDirectory() as tmp:
                sc = Scanner(prof, ScanConfig(device="cuda"))
                with open(sc.run(seqs, os.path.join(tmp, "p"))) as fp:
                    unconf = {strip_evalue(x)
                              for x in fp.read().splitlines()[1:]}
            check(all(strip_evalue(x) in unconf for x in tg[1:]),
                  "confirm_case: a confirmed line is not an unconfirmed one")
        say("subset", f"confirmed, {label}: card and CPU agree ({kept} "
            f"lines, {sum(k.endswith('.h3r') for k in g)} h3r files; every "
            f"column but the e-value byte-identical, score tolerance "
            f"{widest:.3e} bits); largest differences from the f64 run: "
            f"card {drift(recs['card'], recs['cpu f64'])}; CPU f32 "
            f"{drift(recs['cpu'], recs['cpu f64'])}")


def batched_launch(torch, report, scorer, waves) -> None:
    """The confirmed scan's largest batched posterior launch (the most
    hits of one Kpad in one wave) timed again, with the bound of its work
    (all its hits' cells), into the kernels line under "batched"."""
    from deciphon_tpu_torch.hmmer.forward import amino_posterior

    hmms = scorer.hmms
    best = []
    for w in waves:
        hits = [(p, q) for p, q in w if q]
        for ids in scorer.launch_plan(hits, posterior=True):
            if len(ids) > len(best):
                best = [hits[i] for i in ids]
    args, host = scorer._staged(best)
    ms = cuda_ms(torch, lambda: amino_posterior(**args), 3)
    ks = [hmms[p].length for p, _ in best]
    b, by = amino_bound_ms("amino_posterior", args, ks)
    lens = [len(q) for _, q in best]
    Kpad = args["em"].shape[2]
    report["amino_posterior"]["batched"] = dict(
        hits=len(best), Kpad=Kpad, longest=max(lens), positions=sum(lens),
        ms=ms, us_per_position=ms * 1e3 / max(lens), bound_ms=b, bound_by=by)
    say("confirm", f"largest batched posterior launch of the scan: "
        f"{len(best)} hits at Kpad {Kpad} (L {min(lens)}..{max(lens)}, "
        f"{sum(lens)} positions), {ms:.3f} ms, "
        f"{ms * 1e3 / max(lens):.3f} us a position of the longest; bound "
        f"{b:.6f} ms ({by})")
    del host


def confirm_phase(torch, report, launches, profiles, seqs, lines,
                  unconfirmed_med: float, sub_prof, sub_seqs,
                  side: Side) -> None:
    """Phase 8, confirmation: both amino kernels against their plain
    versions at AMINO_KPADS, and batches bit-equal to their hits launched
    alone; the Pfam scan with NativeConfirmer(pfam_scan_hmms(),
    device="cuda") on the batched route (null2, the posterior kernel):
    first scan counted (one posterior launch a (wave, Kpad) group), three
    warm, one profiled (the kernels' device seconds), its lines the
    unconfirmed scan's kept lines; the hit-by-hit route's scan, counted
    (one launch a hit), the same hits and the same bytes; one counted
    scan with null2=False (the Forward kernel); the largest batched
    launch with its bound; the recorded calls with the widest Kpad and
    the longest L against the plain versions on the card; then the card
    against the CPU (confirm_subsets)."""
    from deciphon_tpu_torch.hmmer.forward import NativeConfirmer, _pad_pow2
    from deciphon_tpu_torch.workload import pfam_scan_hmms

    t0 = time.perf_counter()
    check_amino(torch, report)
    hmms = pfam_scan_hmms()
    check([h.accession for h in hmms] == [p.accession for p in profiles],
          "pfam_scan_hmms is not pfam_scan's database")
    native = NativeConfirmer(hmms, device="cuda")
    rec = Recorder(native)
    sc = Scans(torch, profiles, seqs, "confirm", confirmer=rec)
    first, clines = sc.counted(
        launches, ("pchain", "chain", "path", "walk", "amino_posterior"))
    calls, waves = list(rec.calls), list(rec.waves)
    kept = [c for c in calls if c[2] < 0]
    lens = sorted(len(c[1]) for c in calls)
    groups = rec.groups()
    say("confirm", f"first confirmed scan {first:.6f} s: {len(calls)} hits "
        f"confirmed in {len(rec.waves)} waves (amino lengths "
        f"{lens[0]}..{lens[-1]}, median {lens[len(lens) // 2]}), "
        f"{len(kept)} kept, {len(calls) - len(kept)} dropped; log-E of the "
        f"kept {[round(c[2], 3) for c in kept]}; posterior launches "
        f"{sc.counts['amino_posterior']}, (wave, Kpad) groups {groups}")
    check(sc.counts["amino_posterior"] == groups < len(calls),
          "the posterior did not launch once a (wave, Kpad) group")
    unconf = {strip_evalue(x) for x in lines[1:]}
    check(len(clines) - 1 == len(kept) and all(
        strip_evalue(x) in unconf for x in clines[1:]),
        "the confirmed lines are not the unconfirmed scan's kept lines")
    with tempfile.TemporaryDirectory() as tmp:
        sc.scanner.run(seqs, os.path.join(tmp, "p"))
        batched_dir = product_dir(os.path.join(tmp, "p"))
    med = sc.warm_and_profile(clines)
    dev = {k: v for k, v in sc.dev_s.items() if "amino_kernel" in k}
    say("confirm", f"profiled confirmed scan: amino kernels' device s "
        + json.dumps(dev) + f"; warm median confirmed {med:.6f} s, "
        f"unconfirmed (phase 4) {unconfirmed_med:.6f} s, ratio "
        f"{med / unconfirmed_med:.6f}")
    # the hit-by-hit route: a confirmer without confirm_many
    single = Recorder(NativeConfirmer(hmms, device="cuda"), single=True)
    ss = Scans(torch, profiles, seqs, "confirm, hit by hit",
               confirmer=single)
    _, slines = ss.counted(launches, ("amino_posterior",))
    check([c[:2] for c in single.calls] == [c[:2] for c in calls],
          "the two routes confirmed other hits")
    check(ss.counts["amino_posterior"] == sum(1 for c in calls if c[1]),
          "the hit-by-hit route did not launch once a hit")
    with tempfile.TemporaryDirectory() as tmp:
        ss.scanner.run(seqs, os.path.join(tmp, "p"))
        check(product_dir(os.path.join(tmp, "p")) == batched_dir
              and slines == clines,
              "the batched and the hit-by-hit route wrote other bytes")
    say("confirm", f"hit by hit: {ss.counts['amino_posterior']} posterior "
        f"launches; products and h3r files byte-identical to the batched "
        f"route's ({len(batched_dir)} files)")
    del ss, single
    native.null2 = False
    rec.waves = []
    _, flines = sc.counted(launches, ("path", "walk", "amino_forward"))
    native.null2 = True
    check(sc.counts["amino_forward"] == rec.groups(False) > 0 and
          sc.counts["amino_posterior"] == 0, "null2=False ran the posterior")
    check(all(strip_evalue(x) in unconf for x in flines[1:]),
          "null2=False wrote a line the unconfirmed scan did not")
    say("confirm", f"null2=False: {sc.counts['amino_forward']} Forward "
        f"launches, {len(flines) - 1} lines kept")
    del sc
    scorer = native.scorer
    batched_launch(torch, report, scorer, waves)
    wide = max(calls, key=lambda c: (_pad_pow2(hmms[c[0]].length),
                                     len(c[1])))
    long = max(calls, key=lambda c: len(c[1]))
    for what, (p, q, _) in (("the scan's widest-Kpad call", wide),
                            ("the scan's longest call", long)):
        amino_vs_plain(torch, report, scorer.launch_args(p, q),
                       [hmms[p].length], f"{what} (profile {p})")
    confirm_subsets(torch, sub_prof, sub_seqs, hmms, side)
    say("confirm", f"phase {time.perf_counter() - t0:.1f} s")


def cli_run(args: list) -> str:
    """One command of the port's CLI, run in process (so that the launch
    counts can be read); returns what it printed."""
    import io

    from deciphon_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main([str(a) for a in args], standalone_mode=False)
    return out.getvalue()


def snap_members(path: str) -> dict:
    """{member path below the archive's root: bytes} of a .dcs (zip
    members, not zip bytes: the timestamps differ)."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        return {n.split("/", 1)[1]: z.read(n) for n in z.namelist()
                if not n.endswith("/")}


def cli_scan(torch, launches: dict, args: list, need: tuple,
             phase: str = "cli") -> tuple[float, dict]:
    """`scan` through the CLI with the launch counts set to 0 just before
    and read just after; every kernel in `need` must have launched, and
    the counts go into `launches`.  Returns (wall, snap members)."""
    from deciphon_tpu_torch.ops import traceback as tb
    from deciphon_tpu_torch.ops import viterbi as vk

    snap = args[args.index("--snap") + 1]
    torch.cuda.synchronize()
    vk.reset_launches()
    tb.REWALKS["survivors"] = 0
    t0 = time.perf_counter()
    out = cli_run(["scan", *args, "--no-progress"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(vk.LAUNCHES)
    check(out.strip() == f"wrote {snap}", f"scan printed {out[:200]!r}")
    mem = snap_members(snap)
    rows = mem["products.tsv"].decode().splitlines()[1:]
    say(phase, f"CLI scan {' '.join(map(str, args[2:]))}: wall {wall:.6f} "
        f"s, {len(rows)} products, {sum(k.endswith('.h3r') for k in mem)} "
        f"h3r files; launches {counts}, walks re-walked "
        f"{tb.REWALKS['survivors']}")
    for k in need:
        check(counts[k] > 0, f"kernel {k} never launched on the CLI scan "
              f"({' '.join(map(str, args[2:]))})")
    check(tb.REWALKS["survivors"] == 0, "a walk overflowed its max_steps")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    return wall, mem


def cli_press(tmp: str) -> dict:
    """Phase 9's database, on the host in the side pool: pfam_scan_hmms()
    written as HMMER3 text to `tmp`/pfam.hmm and pressed there by the
    CLI's `press pfam.hmm 1`."""
    from deciphon_tpu_torch.workload import hmm_text, pfam_scan_hmms

    t0 = time.perf_counter()
    hmms = pfam_scan_hmms()
    path = os.path.join(tmp, "pfam.hmm")
    with open(path, "w") as fp:
        fp.write(hmm_text(hmms))
    text_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = cli_run(["press", path, 1, "--no-progress"])
    return dict(out=out, text_s=text_s, press_s=time.perf_counter() - t0,
                profiles=len(hmms), nodes=sum(h.length for h in hmms))


def cli_cpu_scan(args: list) -> dict:
    """A CLI scan with --device cpu: the snap's members, the launch counts
    and the wall."""
    from deciphon_tpu_torch.ops import viterbi as vk

    t0 = time.perf_counter()
    vk.reset_launches()
    cli_run(["scan", *args, "--no-progress", "--device", "cpu"])
    return dict(members=snap_members(args[3]), launches=dict(vk.LAUNCHES),
                seconds=time.perf_counter() - t0)


def cli_phase(torch, launches: dict, tmp: str, side: Side) -> dict:
    """Phase 9, the user's entry points, in the directory `tmp`: the
    Pfam-shaped database as
    HMMER3 text (`workload.hmm_text(pfam_scan_hmms())`), pressed by
    `press X.hmm 1` through the port's CLI; reads planted from the pressed
    profiles (`read_dcp_profiles`) as pfam_scan plants them, as FASTA;
    `scan` through the CLI on the card (first, one warm), its
    products.tsv byte-identical to Scanner.run's and to core.Scan's
    (make_archive) on the same profiles; `see`; `scan --confirm native`
    against the in-process Scanner with NativeConfirmer; and on a subset
    (12 profiles pressed alone, two reads of 1.2 knt) the card's CLI scan
    against `--device cpu`, on the planted read alone against `--engine
    native` (and against the planted profile pressed alone, `--engine
    torch`), and `warmup`.  Returns what phase 11
    reuses: a function naming the files in `tmp` (the texts, the reads and
    the databases), the reads, the subset's reads, the snaps' members and
    the subset's planted profile."""
    import numpy as np

    from deciphon_tpu_torch.core import Batch, Scan, Sequence as CoreSeq
    from deciphon_tpu_torch.hmmer.forward import NativeConfirmer
    from deciphon_tpu_torch.hmmfile import read_hmm
    from deciphon_tpu_torch.io.dcp import read_dcp_profiles
    from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner
    from deciphon_tpu_torch.scan.sequence import Sequence
    from deciphon_tpu_torch.schema import DBFile, NewSnapFile
    from deciphon_tpu_torch.workload import (PFAM_PLANTED, hmm_text,
                                             pfam_scan_hmms, pfam_subset,
                                             planted_read, random_bases)

    t00 = time.perf_counter()
    d = lambda name: os.path.join(tmp, name)  # noqa: E731
    # 1-2. the database as HMMER3 text, pressed through the CLI (both in
    # the side pool, submitted when the script started), then the reader
    pressed = side_result(side, ("press",))
    hmms = pfam_scan_hmms()
    say("cli", f"{pressed['profiles']} profiles ({pressed['nodes']} "
        f"nodes) as HMMER3/f text: {os.path.getsize(d('pfam.hmm'))} "
        f"bytes in {pressed['text_s']:.3f} s (side pool)")
    out, press_s = pressed["out"], pressed["press_s"]
    check(out.startswith(f"wrote {d('pfam.dcp')}"),
          f"press printed {out[:200]!r}")
    t0 = time.perf_counter()
    _, profiles = read_dcp_profiles(d("pfam.dcp"))
    read_s = time.perf_counter() - t0
    check([p.accession for p in profiles]
          == [h.accession for h in hmms], "the .dcp lost a profile")
    say("cli", f"press wall {press_s:.6f} s (side pool), .dcp "
        f"{os.path.getsize(d('pfam.dcp'))} bytes; read_dcp_profiles "
        f"wall {read_s:.6f} s")
    # 3. reads planted from the pressed profiles, as pfam_scan plants
    rng = np.random.default_rng(2024)
    reads = [planted_read(rng, profiles[i], 10_000, noise=0.01)
             for i in PFAM_PLANTED]
    reads += [random_bases(rng, 10_000) for _ in range(8 - len(reads))]
    with open(d("reads.fna"), "w") as fp:
        fp.writelines(f">read{i}\n{r}\n" for i, r in enumerate(reads))
    seqs = [Sequence.make(i + 1, f"read{i}", r)
            for i, r in enumerate(reads)]
    # 4. scan through the CLI: first, then one warm
    need = ("pchain", "chain", "path", "walk")
    first, mem = cli_scan(torch, launches, [
        d("pfam.dcp"), d("reads.fna"), "--snap", d("cli.dcs")], need)
    warm = []
    for i in range(1):
        w, again = cli_scan(torch, launches, [
            d("pfam.dcp"), d("reads.fna"), "--snap", d(f"w{i}.dcs")],
            need)
        check(again == mem, "a warm CLI scan wrote another snap")
        warm.append(w)
    tsv = mem["products.tsv"]
    rows = [r.split("\t") for r in tsv.decode().splitlines()[1:]]
    check(rows, "the CLI scan wrote no products")
    say("cli", f"CLI scan walls: first {first:.6f} s, warm {warm}, "
        f"median {statistics.median(warm):.6f} s (each reads the "
        f".dcp: {read_s:.6f} s)")
    # 5. the same bytes by Scanner.run and by core.Scan
    sc = Scanner(profiles, ScanConfig(device="cuda"))
    walls = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = sc.run(seqs, d(f"inproc{i}"))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        with open(path, "rb") as fp:
            check(fp.read() == tsv, "Scanner.run wrote other products "
                  "than the CLI")
    m = sc.metrics
    say("cli", f"Scanner.run on the pressed profiles: walls {walls} s "
        f"(first, warm), survivors {m.survivors}, products "
        f"{m.products}: products.tsv byte-identical to the CLI's")
    del sc
    batch = Batch()
    for q in seqs:
        batch.add(CoreSeq(q.id, q.name, q.data))
    t0 = time.perf_counter()
    core = Scan(DBFile(path=d("pfam.dcp")))
    snap = NewSnapFile(path=d("core.dcs"))
    core.run(snap, batch)
    snap.make_archive()
    check(core.progress() == 100, "core.Scan did not finish")
    check(snap_members(d("core.dcs")) == mem,
          "core.Scan wrote another snap than the CLI")
    say("cli", f"core.Scan: {time.perf_counter() - t0:.6f} s, snap "
        f"members byte-identical to the CLI's ({sorted(mem)[:3]}...)")
    del core
    # 6. see
    t0 = time.perf_counter()
    seen = cli_run(["see", d("cli.dcs")])
    planted = {profiles[i].accession: n + 1
               for n, i in enumerate(PFAM_PLANTED)}
    hits = sorted({(r[7], int(r[0])) for r in rows
                   if planted.get(r[7]) == int(r[0])})
    check(hits and all(f"{acc} hit 0 query" in seen
                       for acc, _ in hits),
          "see did not show the planted hits")
    check(seen.startswith(f"shape: ({len(rows)}, "),
          "see's table lacks rows")
    say("cli", f"see: {len(seen)} characters in "
        f"{time.perf_counter() - t0:.3f} s; planted hits shown "
        f"(profile, read) {hits}")
    # 7. the confirmed scan: CLI against the in-process Scanner
    _, cmem = cli_scan(torch, launches, [
        d("pfam.dcp"), d("reads.fna"), "--snap", d("conf.dcs"),
        "--confirm", "native"], need + ("amino_posterior",))
    sc = Scanner(profiles, ScanConfig(device="cuda"), confirmer=(
        NativeConfirmer(read_hmm(d("pfam.hmm")), device="cuda").confirm))
    sc.run(seqs, d("conf"))
    check(product_dir(d("conf")) == cmem, "the confirmed CLI scan "
          "wrote other bytes than the in-process confirmed Scanner")
    say("cli", f"confirmed: {len(cmem)} files byte-identical to the "
        f"in-process Scanner with NativeConfirmer "
        f"({sc.metrics.products} lines kept of {sc.metrics.survivors} "
        "survivors)")
    del sc
    # 8. the subset: card against CPU, torch and native engines
    sub_prof, sub_seqs = pfam_subset(profiles)
    idx = [next(i for i, q in enumerate(profiles) if q is p)
           for p in sub_prof]
    with open(d("sub.hmm"), "w") as fp:
        fp.write(hmm_text([hmms[i] for i in idx]))
    cli_run(["press", d("sub.hmm"), 1, "--no-progress"])
    _, back = read_dcp_profiles(d("sub.dcp"))
    check([p.accession for p in back] == [p.accession for p in sub_prof],
          "the subset's .dcp lost a profile")
    with open(d("sub.fna"), "w") as fp:
        fp.writelines(f">{q.name}\n{q.data}\n" for q in sub_seqs)
    # the plain-PyTorch torch and native engines scan the planted read
    # alone (their speed is not what they check), against the kernels
    # on the same read; the torch engine, launch-bound (60-72 s on the
    # 12 profiles), against the planted profile pressed alone, so that
    # the script stays within its time (phase 7 holds that engine to the
    # kernels' bytes on the whole subset)
    with open(d("sub1.fna"), "w") as fp:
        fp.write(f">{sub_seqs[0].name}\n{sub_seqs[0].data}\n")
    with open(d("one.hmm"), "w") as fp:
        fp.write(hmm_text([hmms[SUBSET_PLANTED]]))
    cli_run(["press", d("one.hmm"), 1, "--no-progress"])
    subs = {}
    for label, extra, need_sub, db, fna in (
            ("kernels, cuda", [], ("path", "walk"), "sub.dcp", "sub.fna"),
            ("kernels, cpu", ["--device", "cpu"], (), "sub.dcp", "sub.fna"),
            ("kernels, cuda, 1 read", [], ("path", "walk"), "sub.dcp",
             "sub1.fna"),
            ("native, cuda", ["--engine", "native"], ("walk",), "sub.dcp",
             "sub1.fna"),
            ("kernels, cuda, 1 profile", [], ("path", "walk"), "one.dcp",
             "sub1.fna"),
            ("torch, cuda", ["--engine", "torch"], ("walk",), "one.dcp",
             "sub1.fna")):
        snap_path = d(label.replace(", ", "_").replace(" ", "") + ".dcs")
        t0 = time.perf_counter()
        if label == "kernels, cpu":
            r = cli_cpu_scan([d(db), d(fna), "--snap", snap_path])
            subs[label] = r["members"]
            say("cli", f"subset, {label}: {r['seconds']:.3f} s; launches "
                f"{r['launches']}")
            check(sum(r["launches"].values()) == 0,
                  "--device cpu launched a kernel")
        else:
            _, subs[label] = cli_scan(
                torch, launches, [d(db), d(fna), "--snap",
                                  snap_path, *extra], need_sub,
                "cli subset")
    want_of = {"kernels, cpu": "kernels, cuda",
               "native, cuda": "kernels, cuda, 1 read",
               "torch, cuda": "kernels, cuda, 1 profile"}
    for label, got in subs.items():
        want = subs[want_of.get(label, label)]
        check(want["products.tsv"].count(b"\n") > 1,
              f"the subset's CLI scan ({label}) wrote no products")
        check(got == want, f"subset: {label} wrote another snap than "
              "kernels on the card")
    out = cli_run(["warmup", d("sub.dcp"), "--read-length", 1200,
                   "--reads-per-length", 2])
    check(out.startswith("warmup done in"), f"warmup printed {out!r}")
    say("cli", f"subset ({len(sub_prof)} profiles, 2 reads of 1.2 knt): "
        f"the card's CLI scan byte-identical to --device cpu; on the "
        f"planted read alone to --engine native, and against the planted "
        f"profile alone to --engine torch; {out.strip()}")
    say("cli", f"phase {time.perf_counter() - t00:.1f} s")
    return dict(d=d, seqs=seqs, sub_seqs=sub_seqs, mem=mem, cmem=cmem,
                sub_mem=subs["kernels, cuda"],
                planted=profiles[SUBSET_PLANTED].accession)


def device_busy(torch, prof) -> float | None:
    """Seconds in which the card ran at least one kernel or copy in a
    profiled run: the union of the device events' intervals (kernels of
    two streams overlap, so their sum would count shared time twice);
    None when the trace holds no device interval."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e6


def multi_phase(torch, launches: dict, cells: dict) -> None:
    """Phase 10 ("multi"): the device-parallel scan.  With one card, two
    shards on cuda:0 (each on its own stream); with more, every card.
    The Pfam cell through BucketedPairScorer(devices=...) (first, median
    of 3 warm, one profiled: device busy as the union of its device
    intervals), launches per kernel key per shard, and a ledger scan
    whose bucket names and cells must be phase 4's (`cells["ledger"]`),
    one entry a sharded dispatch; the long read under
    DECIPHON_CHAIN_SEG=1 (carry rows routed across shards); the large-K
    scan (B4 and phase 2 on the first device); engine="kernels-multi";
    two multihost_worker processes (gloo on localhost, --device cuda, the
    pfam workload, 100 + 100 profiles).  Every product byte-identical to
    its one-device phase's; the two processes' all-reduced counters equal
    phase 4's metrics."""
    from torch.profiler import ProfilerActivity, profile

    from deciphon_tpu_torch.parallel import multidevice as md
    from deciphon_tpu_torch.scan.scheduler import BucketedPairScorer

    t00 = time.perf_counter()
    ncard = torch.cuda.device_count()
    devices = (["cuda:0"] * 2 if ncard == 1
               else [f"cuda:{i}" for i in range(ncard)])
    say("multi", f"{ncard} card(s): shards on {devices}")

    def sharded(costs):
        return BucketedPairScorer(costs, "cuda", devices=devices)

    def run(name, profiles, seqs, want, need, env=None, **kw):
        sc = Scans(torch, profiles, seqs, f"multi {name}", **kw)
        md.reset_shard_launches()
        first, lines = sc.counted(launches, need, env)
        check(lines == want, f"multi {name}: products differ from the "
              "one-device scan's")
        say("multi", f"{name}: first scan {first:.6f} s, products "
            f"byte-identical to the one-device scan's; launches by shard "
            f"{json.dumps(md.SHARD_LAUNCHES)}; carry rows routed "
            f"{dict(md.ROUTED)}")
        return sc, first

    # 1. the Pfam cell, two shards
    pfam, first = run("pfam", cells["profiles"], cells["seqs"],
                      cells["lines"], ("pchain", "chain", "path", "walk"),
                      scorer=sharded)
    scorers = pfam.scanner.scorer.scorers
    check(all(isinstance(s, (md.MultiDevicePairScorer,
                             md.MultiDevicePackedScorer)) for s in scorers),
          "a Pfam scorer is not sharded")
    check(all(set(s._replicas) in (set(), set(s.distinct))
              for s in scorers) and any(s._replicas for s in scorers),
          "a scorer holds its tables elsewhere than once a distinct device")
    for k in ("pchain", "chain"):
        check(all(md.SHARD_LAUNCHES.get(i, {}).get(k, 0) > 0
                  for i in range(len(devices))),
              f"a shard launched no {k}")
    warm = []
    for _ in range(3):
        w, again = pfam.scan()
        check(again == cells["lines"], "a warm sharded scan wrote other "
              "products")
        warm.append(w)
    med = statistics.median(warm)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, again = pfam.scan()
    check(again == cells["lines"], "the profiled sharded scan wrote other "
          "products")
    busy = device_busy(torch, prof)
    ksum = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()) / 1e6
    say("multi", f"pfam, {len(devices)} shards: first {first:.6f} s, warm "
        f"{warm} s, median {med:.6f} s ({len(cells['seqs']) / med:.6f} "
        f"reads/s); one shard (phase 4): first {cells['first']:.6f} s, "
        f"median {cells['med']:.6f} s; ratio {med / cells['med']:.6f}; "
        f"profiled scan: wall {wall:.6f} s, device busy (union) "
        + (f"{busy:.6f} s, idle share {max(0.0, 1 - busy / wall):.6f}"
           if busy is not None else "not measured")
        + f", kernel time summed {ksum:.6f} s")
    # the shards' ledger: one entry a sharded dispatch, under phase 4's
    # names with phase 4's cells
    pfam.ledger(cells["lines"], shards=len(devices),
                one_device=cells["ledger"])
    del pfam, prof

    # 2. the long read, carry segments routed across shards
    long, _ = run("long read, DECIPHON_CHAIN_SEG=1", cells["profiles"],
                  cells["long_seqs"], cells["long_lines"],
                  ("carry", "path", "walk"), {"DECIPHON_CHAIN_SEG": "1"},
                  scorer=sharded)
    check(md.ROUTED["rows"] > 0, "no carry row was routed")
    del long

    # 3. the large-K scan: B4 and phase 2 on the first device
    big, _ = run("large K", cells["big_prof"], cells["big_seqs"],
                 cells["big_lines"], ("large", "path", "walk"),
                 scorer=sharded)
    check(all(s.hbm_table and list(s._replicas) == [s.mesh[0]]
              for s in big.scanner.scorer.scorers),
          "a large-K scorer left the first device")
    check(set(md.SHARD_LAUNCHES) <= {0}, "B4 ran past the first shard")
    del big

    # 4. ScanConfig(engine="kernels-multi") on the Pfam cell
    km, _ = run("engine=kernels-multi", cells["profiles"], cells["seqs"],
                cells["lines"], ("pchain", "chain", "path", "walk"),
                engine="kernels-multi")
    multi = any(isinstance(s, (md.MultiDevicePairScorer,
                               md.MultiDevicePackedScorer))
                for s in km.scanner.scorer.scorers)
    check(multi == (ncard > 1), "kernels-multi did not follow the card "
          "count")
    say("multi", f"engine=kernels-multi over {ncard} card(s): "
        + ("sharded" if multi else "the one-device path, as the "
           "reference's pallas-multi on one device"))
    del km
    torch.cuda.empty_cache()

    # 5. two processes, gloo on localhost, 100 + 100 profiles (started with
    # phase 9 where it ran)
    dryrun = cells["dry"] or DryRun()
    wall, walls = dryrun.result()
    shared = dryrun.shared
    with open(os.path.join(shared, "products.tsv")) as fp:
        merged = fp.read().splitlines()
    metas = []
    for pid in range(2):
        with open(os.path.join(shared, f"shard.{pid}.meta")) as fp:
            metas.append(json.load(fp))
    with open(os.path.join(shared, "merge.json")) as fp:
        merge = json.load(fp)
    dryrun.cleanup()
    check(merged == cells["lines"], "the two processes' merged products "
          "differ from phase 4's")
    check([m["stop"] - m["start"] for m in metas] == [100, 100],
          "the processes did not split the profiles 100 + 100")
    check(all(m["counters"] == cells["counters"] for m in metas),
          f"all-reduced counters {metas[0]['counters']} differ from phase "
          f"4's metrics {cells['counters']}")
    say("multi", f"2 processes (gloo, --device cuda, pfam workload, "
        f"started {dryrun.started}): wall {wall:.6f} s; each worker to its exit {walls} s, its scan "
        f"(Scanner set-up and run) {[m['scan_s'] for m in metas]} s; "
        f"process 0 waited {merge['wait_s']:.6f} s and merged in "
        f"{merge['merge_s']:.6f} s; merged products byte-identical to "
        f"phase 4's; all-reduced counters {metas[0]['counters']} equal "
        "phase 4's metrics")
    say("multi", f"phase {time.perf_counter() - t00:.1f} s")


class DryRun:
    """Phase 10's two multihost_worker processes (gloo on localhost,
    --device cuda, the pfam workload, 100 + 100 profiles), as
    multihost_dryrun.run_procs starts them.  The script starts them with
    phase 9, beside it (each spends most of its wall building the
    workload on the host), and reads them in phase 10; a thread a worker
    takes its wall to its exit."""

    def __init__(self, started: str = "with phase 10"):
        import shutil
        import threading

        from deciphon_tpu_torch.parallel import multihost_dryrun as dry

        self.started = started
        self.shared = tempfile.mkdtemp(prefix="chip_smoke_dry_")
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        extra = ["--workload", "pfam", "--device", "cuda", "--coordinator",
                 f"127.0.0.1:{dry.free_port()}"]
        self.t0 = time.perf_counter()
        self.logs = [open(os.path.join(self.shared, f"worker.{pid}.log"),
                          "wb") for pid in range(2)]
        # at a lower CPU priority than the card's process, which runs on
        nice = shutil.which("nice")
        lower = [nice, "-n", str(HELPER_NICE)] if nice else []
        self.procs = [subprocess.Popen(
            lower + dry.worker_cmd(pid, 2, self.shared, extra),
            cwd=dry.ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
            for pid, log in enumerate(self.logs)]
        self.walls: list = [None, None]

        def wait(pid: int) -> None:
            self.procs[pid].wait()
            self.walls[pid] = time.perf_counter() - self.t0

        self.threads = [threading.Thread(target=wait, args=(pid,),
                                         daemon=True) for pid in range(2)]
        for t in self.threads:
            t.start()

    def result(self, timeout: float = 300.0) -> tuple[float, list]:
        """(wall of both, each worker's wall to its exit); a worker that
        failed, or outlasted `timeout` s from the start, fails the
        phase."""
        for t in self.threads:
            t.join(max(0.0, timeout - (time.perf_counter() - self.t0)))
        if any(p.poll() is None for p in self.procs):
            self.stop()
            fail(f"the dry-run workers outlasted {timeout} s")
        for log in self.logs:
            log.close()
        for pid, p in enumerate(self.procs):
            if p.returncode != 0:
                with open(self.logs[pid].name, "rb") as fp:
                    sys.stderr.write(fp.read()[-4000:].decode(
                        errors="replace"))
                fail(f"dry-run worker {pid} failed rc={p.returncode}")
        return max(self.walls), list(self.walls)

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()

    def cleanup(self) -> None:
        import shutil

        self.stop()
        shutil.rmtree(self.shared, ignore_errors=True)


def entry_phase(torch, launches: dict, run) -> None:
    """Phase 12 ("entry"): the graft entry points
    (deciphon_tpu_torch/graft_entry.py).  `entry("cuda")`'s scan step
    (ops/engine.scan_scores, plain PyTorch: no kernel of its own) on its
    seven example tensors, bit-equal to `entry("cpu")`'s; held against B9
    (GridScanEngine.scores, one launch) on the same profiles and windows
    within the cross-engine tolerance (rtol 2e-6, atol 2e-5), and bit for
    bit wherever the plain versions of the two agree bit for bit on the
    CPU; then `dryrun_multichip(2, "cuda")` (the production scan over two
    shards of the card and on one device, byte-identical) as a main path,
    its wall and survivors, its products those of phase 7's subset scan
    at the reference's caps where phase 7 ran, and its workload
    `pfam_subset()` that of the Pfam database where one was built."""
    import numpy as np

    from deciphon_tpu_torch import graft_entry as ge
    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.ops.costs import build_costs
    from deciphon_tpu_torch.ops.engine import ProfilePack, lrt_tile
    from deciphon_tpu_torch.profile import sample_profile
    from deciphon_tpu_torch.workload import pfam_subset

    t00 = time.perf_counter()
    fn, args = ge.entry()
    check(all(a.is_cuda for a in args), "entry() left a tensor off the card")
    vk.reset_launches()
    t0 = time.perf_counter()
    got = [o.cpu().numpy() for o in fn(*args)]
    ms = (time.perf_counter() - t0) * 1e3
    check(not any(vk.LAUNCHES.values()), "entry()'s step launched a kernel")
    cfn, cargs = ge.entry("cpu")
    want = [o.numpy() for o in cfn(*cargs)]
    check(all(g.dtype == w.dtype and g.shape == w.shape == (2, 2)
              and np.array_equal(g, w) for g, w in zip(got, want)),
          "entry('cuda') differs from entry('cpu')")
    shapes = [tuple(a.shape) for a in args]
    say("entry", f"entry('cuda'): scan_scores on {shapes}, {ms:.3f} ms, "
        f"(null, alt) {[g.tolist() for g in got]} (LRT "
        f"{lrt_tile(*got).tolist()}), bit for bit entry('cpu')'s")

    # B9 on the same profiles and windows
    costs = [build_costs(sample_profile(seed=10 + i, core_size=24))
             for i in range(2)]
    check(np.array_equal(ProfilePack.from_costs(costs, lane_multiple=8).core,
                         cargs[0].numpy()), "the grid's profiles are not "
          "entry()'s")
    _, xt, codes, lengths = ge._tiny_workload(2, 24, 2, 48)
    plain = vk.GridScanEngine(costs, "cpu").scores(xt, codes, lengths)
    vk.reset_launches()
    grid = vk.GridScanEngine(costs, "cuda").scores(xt, codes, lengths)
    check(vk.LAUNCHES["grid"] == 1, "GridScanEngine.scores did not launch B9")
    for what, g, b, p in zip(("null", "alt"), got, grid, plain):
        bit = p == g  # where the plain versions agree bit for bit
        check(np.allclose(b, g, rtol=2e-6, atol=2e-5),
              f"B9's {what} differs from entry()'s past rtol 2e-6, atol 2e-5")
        check(np.array_equal(b[bit], g[bit]), f"B9's {what} differs bit for "
              "bit where the plain versions agree")
        say("entry", f"B9 against entry('cuda'), {what}: max abs error "
            f"{float(np.abs(b - g).max()):.3g}, {int((b == g).sum())} of "
            f"{g.size} bit-equal ({int(bit.sum())} where the plain versions "
            "are)")

    # the dry run: two shards on the card against one device
    vk.reset_launches()
    t0 = time.perf_counter()
    products, survivors = ge.dryrun_multichip(2, "cuda")
    wall = time.perf_counter() - t0
    counts = dict(vk.LAUNCHES)
    for k in ("pchain", "path", "walk"):
        check(counts[k] > 0, f"kernel {k} never launched on the dry run")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    say("entry", f"dryrun_multichip(2, 'cuda'): {wall:.3f} s (two Scanners "
        f"built and run: 2 shards of cuda:0, then one device), survivors "
        f"{survivors}, {products.count(chr(10)) - 1} products, "
        f"byte-identical; launches {counts}")
    if getattr(run, "subset_bytes", None) is not None:
        check(products == run.subset_bytes, "the dry run's products are not "
              "phase 7's subset scan's")
        say("entry", "dry run products: phase 7's subset scan's, byte for "
            "byte")
    if run._db is not None:
        a, b = pfam_subset(), pfam_subset(run._db[0])
        check([vars(p).keys() == vars(q).keys() and all(
            np.array_equal(v, getattr(q, k)) if isinstance(v, np.ndarray)
            else v == getattr(q, k) for k, v in vars(p).items())
            for p, q in zip(a[0], b[0])] == [True] * len(b[0])
            and [q.data for q in a[1]] == [q.data for q in b[1]],
            "pfam_subset() differs from the Pfam database's subset")
    say("entry", f"phase {time.perf_counter() - t00:.1f} s")


SERVICE_NEED = ("pchain", "chain", "path", "walk")  # B7, B3, B2, the walk
SERVICE_VIEWS = ("prods", "gff", "queries", "states", "codons", "aminos",
                 "view")
JOB_DEADLINE = 600.0  # seconds the subprocess worker may take for its job
DAEMON_READ_COPIES = 24  # the Pfam reads repeated: a scan of several waves
POLL_S = 5.0  # the long-poll of `cli worker` (WorkerLoop.run_forever)


def ctl_run(url: str, args: list) -> str:
    """One deciphonctl command of the port, run in process; returns what
    it printed."""
    import io

    from deciphon_tpu_torch import control

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        control.cli.main(["--sched", url, *map(str, args)],
                         prog_name="deciphonctl", standalone_mode=False)
    return out.getvalue()


def job_done(poster, job_id: int, what: str) -> dict:
    """The job, which must have ended `done` at progress 100; a failed
    job's error is printed in full before the phase fails."""
    job = poster.job_get(job_id)
    if job["state"] != "done":
        say("services", f"{what}: job {job_id} ended {job['state']!r}, "
            f"error:\n{job['error']}")
        fail(f"{what}: job {job_id} ended {job['state']}, not done")
    check(job["progress"] == 100, f"{what}: job at progress "
          f"{job['progress']}")
    return job


def snap_views(products) -> dict:
    """The views the scheduler serves, computed from a snap's own
    Products."""
    from deciphon_tpu_torch.snap.view import view_alignments

    views = {"prods": [{"seq_id": p.seq_id, "profile": p.profile,
                        "abc": p.abc, "lrt": p.lrt, "evalue": p.evalue}
                       for p in products],
             "gff": products.gff_list().format(),
             "view": view_alignments(products)}
    for kind, elem in (("queries", "query"), ("states", "state"),
                       ("codons", "codon"), ("aminos", "amino")):
        views[kind] = products.fasta_list(elem).format()
    return views


def services_phase(torch, launches: dict, cli: dict) -> None:
    """Phase 11 ("services"): the scheduler, its workers, deciphonctl, the
    worker daemons and the GUI controller, on phase 9's inputs (`cli`).
    A scheduler in process (port 0) and an in-process card worker
    (WorkerLoop(Poster(url), engine="kernels", device="cuda"), so that
    the launch counts can be read): `hmm add pfam.hmm` through deciphonctl
    (a press job: host press, the .dcp uploaded, the db posted; the .dcp
    byte-identical to phase 9's); `scan post` of phase 9's reads, cold and
    warm (B7, B3, B2 and the walk must launch; products.tsv byte-identical
    to phase 9's CLI scan; the scheduler's views equal to the snap's own);
    a confirmed job on a second worker (confirm="native": it downloads the
    .dcp and the text; the posterior must launch; the snap's members
    those of phase 9's `scan --confirm native`), the first worker's
    Scanners released before it; on phase 9's 12-profile subset, a job run
    by `python -m deciphon_tpu_torch.cli worker --device cuda` in a process
    of its own (it downloads the db), then the same job by the in-process
    card worker and by one on the CPU, all three snaps equal to phase 9's
    subset scan; GuiController(device="cuda") pressing and scanning the
    planted read; a ScannerDaemon scan of the Pfam reads interrupted once
    its progress is above 0, then a request served whole with phase 9's
    products.  Every job must end `done`; a failed job's error is printed
    in full."""
    import filecmp
    import shutil
    import threading
    from datetime import datetime

    from deciphon_tpu_torch.gui import GuiController
    from deciphon_tpu_torch.ops import traceback as tb
    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.poster import Poster
    from deciphon_tpu_torch.scan.pipeline import Scanner
    from deciphon_tpu_torch.scan.sequence import Sequence
    from deciphon_tpu_torch.sched import SchedServer, SchedSettings
    from deciphon_tpu_torch.snap.snap_file import read_snap
    from deciphon_tpu_torch.worker import launch_scanner
    from deciphon_tpu_torch.worker.progressor import Interrupted
    from deciphon_tpu_torch.worker_daemon import WorkerLoop

    t00 = time.perf_counter()
    d = cli["d"]
    walls = {}
    moves = []  # (kind, what, bytes, seconds) of each .dcp/.hmm transfer

    class TimedPoster(Poster):
        """Poster whose uploads and downloads are timed."""

        def upload(self, kind, path, progress=None):
            t0 = time.perf_counter()
            super().upload(kind, path, progress)
            moves.append(("upload", os.path.basename(path),
                          os.path.getsize(path), time.perf_counter() - t0))

        def download(self, kind, name, dest):
            t0 = time.perf_counter()
            out = super().download(kind, name, dest)
            moves.append(("download", name, os.path.getsize(dest),
                          time.perf_counter() - t0))
            return out

    runs = []  # (thread name, seconds) of each Scanner.run in this phase
    real_run = Scanner.run

    def timed_run(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return real_run(self, *a, **kw)
        finally:
            torch.cuda.synchronize()
            runs.append((threading.current_thread().name,
                         time.perf_counter() - t0))

    def counted_job(loop, what: str, need: tuple) -> tuple[float, dict]:
        """Run the next queued job on `loop` with the launch counts set to
        0 just before and read just after; each kernel of `need` must have
        launched.  Returns (seconds of the job, counts)."""
        torch.cuda.synchronize()
        vk.reset_launches()
        tb.REWALKS["survivors"] = 0
        t0 = time.perf_counter()
        check(loop.poll_once(timeout=0), f"{what}: no job was claimed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(vk.LAUNCHES)
        for k in need:
            check(counts.get(k, 0) > 0, f"kernel {k} never launched on the "
                  f"services path ({what})")
        check(tb.REWALKS["survivors"] == 0, "a walk overflowed its "
              "max_steps")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return wall, counts

    def scan_job(url, poster, loop, db_id, fna, what, need):
        """`scan post` through deciphonctl, the job on `loop`, `snap get`;
        returns (scan id, snap members, queue-to-done seconds, the job's
        Scanner.run seconds, counts)."""
        n_runs = len(runs)
        t0 = time.perf_counter()
        scan = json.loads(ctl_run(url, ["scan", "post", db_id, fna]))
        job_s, counts = counted_job(loop, what, need)
        job_done(poster, scan["job"]["id"], what)
        wall = time.perf_counter() - t0
        dest = d(f"{what.replace(' ', '_')}.dcs")
        out = ctl_run(url, ["snap", "get", scan["id"], dest])
        check(out.strip() == f"wrote {dest}", f"snap get printed {out!r}")
        run_s = sum(s for _, s in runs[n_runs:])
        say("services", f"{what}: scan job {scan['id']} queue to done "
            f"{wall:.6f} s (the worker's poll {job_s:.6f} s, of it "
            f"Scanner.run {run_s:.6f} s); launches {counts}")
        walls[what] = (wall, run_s)
        return scan["id"], snap_members(dest), dest

    def drop_scan(url, poster, scan_id):
        """`scan rm`: its sequences go with it, so that the next scan's
        sequence ids start at 1 again, as in phase 9's files."""
        ctl_run(url, ["scan", "rm", scan_id])
        check(poster.seq_list() == [], "scan rm left sequences behind")

    sched_dir = d("sched")
    proc = None
    Scanner.run = timed_run
    try:
        with SchedServer(SchedSettings(host="127.0.0.1", port=0,
                                       data_dir=sched_dir)) as server:
            url = server.url
            poster = TimedPoster(url)
            check(poster.handshake() == {"status": "ok"}, "no health")
            loop = WorkerLoop(TimedPoster(url), workdir=d("w1"),
                              engine="kernels", device="cuda")
            # 1. the press job
            t0 = time.perf_counter()
            hmm = json.loads(ctl_run(url, ["hmm", "add", d("pfam.hmm")]))
            check(hmm["job"]["state"] == "pend", f"hmm add gave {hmm}")
            check(loop.poll_once(timeout=0), "the press job was not claimed")
            job = job_done(poster, hmm["job"]["id"], "press")
            walls["press"] = time.perf_counter() - t0
            stored = os.path.join(sched_dir, "files", "pfam.dcp")
            check(filecmp.cmp(stored, d("pfam.dcp"), shallow=False),
                  "the uploaded .dcp is not phase 9's pfam.dcp")
            dbs = json.loads(ctl_run(url, ["db", "ls"]))
            check([x["file"]["name"] for x in dbs] == ["pfam.dcp"],
                  f"db ls gave {dbs}")
            db_id = dbs[0]["id"]
            say("services", f"press job {hmm['job']['id']}: queue to done "
                f"{walls['press']:.6f} s (sched clock {job['exec_started']} "
                f"-> {job['exec_ended']}), .dcp "
                f"{os.path.getsize(stored)} bytes byte-identical to phase "
                f"9's; transfers {moves}")
            # 2. scan jobs on the card worker: cold, then warm
            sid, mem, dest = scan_job(url, poster, loop, db_id,
                                      d("reads.fna"), "pfam cold",
                                      SERVICE_NEED)
            check(mem["products.tsv"] == cli["mem"]["products.tsv"],
                  "the scan job wrote other products than phase 9's CLI "
                  "scan")
            check(mem == cli["mem"], "the scan job's snap members differ "
                  "from phase 9's CLI scan")
            own = snap_views(read_snap(dest).products)
            for kind in SERVICE_VIEWS:
                out = ctl_run(url, ["snap", kind, sid])
                got = json.loads(out) if kind == "prods" else out[:-1]
                want = (json.loads(json.dumps(own[kind])) if kind == "prods"
                        else own[kind])
                check(got == want, f"the scheduler's {kind} view differs "
                      "from the snap's own")
            say("services", f"scheduler views {SERVICE_VIEWS} equal to the "
                f"snap's own Products ({len(own['prods'])} products)")
            drop_scan(url, poster, sid)
            sid, warm, _ = scan_job(url, poster, loop, db_id, d("reads.fna"),
                                    "pfam warm", SERVICE_NEED)
            check(warm == mem, "the warm scan job wrote another snap")
            drop_scan(url, poster, sid)
            # 3. the confirmed job on a second worker, the first released
            loop.release()
            conf = WorkerLoop(TimedPoster(url), workdir=d("w2"),
                              engine="kernels", confirm="native",
                              device="cuda")
            n_moves = len(moves)
            sid, cmem, _ = scan_job(url, poster, conf, db_id, d("reads.fna"),
                                    "pfam confirmed",
                                    SERVICE_NEED + ("amino_posterior",))
            check(cmem == cli["cmem"], "the confirmed scan job's snap differs "
                  "from phase 9's scan --confirm native")
            check({m[1] for m in moves[n_moves:]} >= {"pfam.dcp", "pfam.hmm"}
                  and all(m[0] == "download" for m in moves[n_moves:]),
                  f"the confirmed worker did not download: {moves[n_moves:]}")
            say("services", f"confirmed job: snap members "
                f"({len(cmem)} files) byte-identical to phase 9's; the "
                f"worker's downloads {moves[n_moves:]}")
            drop_scan(url, poster, sid)
            conf.release()
            del conf
            # 4. the real entry point on the subset, in a process of its own
            hmm = json.loads(ctl_run(url, ["hmm", "add", d("sub.hmm")]))
            check(loop.poll_once(timeout=0), "the subset's press job")
            job_done(poster, hmm["job"]["id"], "subset press")
            (sub_db,) = [x["id"] for x in poster.db_list()
                         if x["file"]["name"] == "sub.dcp"]
            scan = json.loads(ctl_run(url, ["scan", "post", sub_db,
                                             d("sub.fna")]))
            log_path = d("worker.log")
            env = dict(os.environ, PYTHONPATH=HERE, PYTHONUNBUFFERED="1")
            start = time.time()
            with open(log_path, "w") as log:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "deciphon_tpu_torch.cli", "worker",
                     "--sched", url, "--device", "cuda", "--workdir",
                     d("w3")], cwd=HERE, env=env, stdout=log,
                    stderr=subprocess.STDOUT)
            deadline = time.monotonic() + JOB_DEADLINE
            while (poster.job_get(scan["job"]["id"])["state"]
                   in ("pend", "run")):
                if proc.poll() is not None or time.monotonic() > deadline:
                    with open(log_path) as fp:
                        say("services", "worker process log:\n" + fp.read())
                    fail("the worker process exited or passed its deadline "
                         "before its job ended")
                time.sleep(0.2)
            job = job_done(poster, scan["job"]["id"], "worker process")
            alive = proc.poll() is None
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
            ended = time.monotonic()
            check(alive, "the worker process exited on its own")
            claimed = datetime.fromisoformat(
                job["exec_started"].replace("Z", "+00:00")).timestamp()
            walls["process start to claim"] = claimed - start
            with open(log_path) as fp:
                log_text = fp.read()
            check(f"worker consuming from {url}" in log_text,
                  f"the worker process printed {log_text[-2000:]!r}")
            check(os.path.exists(d("w3/sub.dcp")), "the worker process did "
                  "not download the subset's .dcp")
            dest = d("process.dcs")
            ctl_run(url, ["snap", "get", scan["id"], dest])
            sub_mems = {"worker process, cuda": snap_members(dest)}
            drop_scan(url, poster, scan["id"])
            say("services", f"worker process: start to its first claimed "
                f"job {walls['process start to claim']:.6f} s, job done, "
                "terminated while polling")
            # the scheduler serves the ended worker's last long-poll to its
            # end (POLL_S), and would hand it a job posted meanwhile: post
            # the next one after it
            time.sleep(max(0.0, POLL_S + 0.5 - (time.monotonic() - ended)))
            cpu = WorkerLoop(Poster(url), workdir=d("w4"), device="cpu")
            for label, worker, need in (
                    ("in process, cuda", loop, ("path", "walk")),
                    ("in process, cpu", cpu, ())):
                sid, sub_mems[label], _ = scan_job(
                    url, poster, worker, sub_db, d("sub.fna"),
                    f"subset {label.split(', ')[1]}", need)
                drop_scan(url, poster, sid)
            for label, got in sub_mems.items():
                check(got == cli["sub_mem"], f"subset, {label}: another "
                      "snap than phase 9's subset scan on the card")
            say("services", f"subset: {sorted(sub_mems)} snaps equal to "
                "phase 9's subset scan")
            loop.release()
            del loop, cpu
        # 5. the GUI controller and the scanner daemon
        os.makedirs(d("gui"))
        gui = GuiController(workdir=d("gui"), device="cuda")
        seen = []
        try:
            gui.press(d("sub.hmm"), progress=seen.append)
            check(seen and seen[-1] == 100 and seen == sorted(seen),
                  f"the GUI's press progress {seen}")
            planted = cli["sub_seqs"][0]
            torch.cuda.synchronize()
            vk.reset_launches()
            t0 = time.perf_counter()
            view = gui.scan_text(f">{planted.name}\n{planted.data}\n")
            gui_s = time.perf_counter() - t0
            counts = dict(vk.LAUNCHES)
        finally:
            gui.close()
        check(cli["planted"] in view, "the GUI's view does not name the "
              "planted profile")
        for k in ("path", "walk"):
            check(counts.get(k, 0) > 0, f"kernel {k} never launched on the "
                  "GUI's scan")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        say("services", f"GUI: press progress {seen[:3]}..{seen[-1]}, scan "
            f"of the planted read {gui_s:.6f} s names "
            f"{cli['planted']}; launches {counts}")
        reads = [Sequence.make(i + 1, f"copy{i}", q.data) for i, q in
                 enumerate(cli["seqs"] * DAEMON_READ_COPIES)]
        with launch_scanner(d("pfam.dcp"), device="cuda") as daemon:
            prog = daemon.put(d("stopped.dcs"), reads)
            deadline = time.monotonic() + JOB_DEADLINE
            while prog.progress == 0 and not prog.done():
                check(time.monotonic() < deadline, "the daemon's scan made "
                      "no progress before its deadline")
                time.sleep(0.01)
            at = prog.progress
            prog.interrupt()
            exc = prog.exception(timeout=JOB_DEADLINE)
            # between two waves the Scanner stops; after its last one the
            # daemon does
            check(isinstance(exc, (Scanner.Interrupted, Interrupted)),
                  f"the interrupted scan ended with {exc!r} (progress {at})")
            check(not os.path.exists(d("stopped.dcs")),
                  "the interrupted scan wrote a snap")
            torch.cuda.synchronize()
            vk.reset_launches()
            t0 = time.perf_counter()
            prog = daemon.put(d("daemon.dcs"), cli["seqs"])
            prog.result(timeout=JOB_DEADLINE)
            torch.cuda.synchronize()
            daemon_s = time.perf_counter() - t0
            counts = dict(vk.LAUNCHES)
        for k in SERVICE_NEED:
            check(counts.get(k, 0) > 0, f"kernel {k} never launched on the "
                  "daemon's scan")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        check(snap_members(d("daemon.dcs")) == cli["mem"], "the daemon's "
              "scan on its own thread wrote another snap than phase 9's")
        say("services", f"daemon: {len(reads)} reads interrupted at progress "
            f"{at} with {type(exc).__name__}; the next request (8 reads) "
            f"{daemon_s:.6f} s, its snap phase 9's; launches {counts}")
    finally:
        Scanner.run = real_run
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(sched_dir, ignore_errors=True)
    say("services", f"walls (s): {json.dumps(walls)}; transfers (kind, "
        f"file, bytes, s): {moves}")
    say("services", f"phase {time.perf_counter() - t00:.1f} s")


T0 = time.perf_counter()


def elapsed(phase: str) -> None:
    say("time", f"phases up to {phase} done at "
        f"{time.perf_counter() - T0:.1f} s")


# The phases in the order they run.  `--phases` names some of them; the
# ones they need run too (NEEDS, transitively), and 1 and 2 always do.
PHASES = ("1", "2", "3", "3b", "4", "5", "5b", "5c", "5d", "6", "7", "8",
          "9", "10", "11", "12")
NEEDS = {"5c": ("4", "5"), "6": ("4", "5", "5b", "5d"), "8": ("4",),
         "10": ("4", "5", "5b"), "11": ("9",)}
# Kernels each phase's main paths launch (its counted runs; the closing
# "never launched" check of a selection covers the selected phases'), and
# those whose time per DP position it records (the closing "no time per
# position" check).  A full run checks every phase against its row and
# that the rows cover every kernel.
PHASE_KERNELS = {
    "3b": ("grid",),
    "4": ("pchain", "chain", "packed", "score", "path", "walk"),
    "5": ("chain", "gang", "carry", "path", "walk"),
    "5b": ("large", "path", "walk"),
    "5c": ("pchain", "chain", "gang_large", "path", "walk"),
    "5d": ("chain", "gang", "score", "carry", "path", "walk"),
    "7": ("walk",),
    "8": ("amino_forward", "amino_posterior", "path", "walk"),
    "9": ("pchain", "chain", "path", "walk", "amino_posterior"),
    "10": ("pchain", "chain", "carry", "large", "path", "walk"),
    "11": ("pchain", "chain", "path", "walk", "amino_posterior"),
    "12": ("pchain", "path", "walk"),
}
PHASE_TIMED = {
    "3b": ("grid",),
    "5c": ("gang_large",),
    "6": ("score", "chain", "gang", "carry", "large", "packed", "pchain",
          "path", "walk"),
    "8": ("amino_forward", "amino_posterior"),
}


def select_phases(spec: str | None) -> list[str]:
    """The phases to run, in order: all without `spec`; else those that
    `spec` names ("1-6,12": single phases and ranges in PHASES' order),
    with the phases they need, and 1 and 2."""
    if spec is None:
        return list(PHASES)
    chosen = {"1", "2"}
    for part in spec.split(","):
        lo, _, hi = part.strip().partition("-")
        hi = hi or lo
        check(lo in PHASES and hi in PHASES
              and PHASES.index(lo) <= PHASES.index(hi),
              f"--phases: {part!r} names no phase or range of {PHASES}")
        chosen.update(PHASES[PHASES.index(lo):PHASES.index(hi) + 1])
    todo = list(chosen)
    while todo:
        for p in NEEDS.get(todo.pop(), ()):
            if p not in chosen:
                chosen.add(p)
                todo.append(p)
    return [p for p in PHASES if p in chosen]


def host_data(name: str):
    """A scan's host data ("db": `workload.pfam_scan()`, "largek":
    `workload.pfam_largek()`, "midk": `workload.pfam_midk()`), built in
    the side pool: (data, seconds)."""
    from deciphon_tpu_torch import workload as wl

    t0 = time.perf_counter()
    data = {"db": wl.pfam_scan, "largek": wl.pfam_largek,
            "midk": wl.pfam_midk}[name]()
    return data, time.perf_counter() - t0


# the phases that read the Pfam database (Run.db) and the large-K data
# (Run.largek): the side pool builds them when one of these runs
DB_PHASES = ("4", "5", "7", "8", "10")
LARGEK_PHASES = ("5b", "7", "10")
MIDK_PHASES = ("5d",)


class Run:
    """What the phases hand on: the kernels line (`report`), the main
    paths' launch counts (`launches`), the side pool, the databases
    (built once, in the side pool where it was asked to, else on first
    use) and each phase's results."""

    def __init__(self, torch, side: Side):
        self.torch = torch
        self.side = side
        self.report: dict = {}
        self.launches: dict[str, int] = {}
        self._db = self._big = self._mid = None

    def _host(self, name: str):
        if (name,) in self.side.jobs:
            data, secs = side_result(self.side, (name,))
            return data, f"{secs:.1f} s (side pool)"
        t0 = time.perf_counter()
        data = host_data(name)[0]
        return data, f"{time.perf_counter() - t0:.1f} s"

    def db(self):
        """The Pfam-shaped database and its 8 reads of 10 knt."""
        if self._db is None:
            from deciphon_tpu_torch.workload import PFAM_PLANTED

            self._db, took = self._host("db")
            ks = [p.core_size for p in self._db[0]]
            say("scan", f"200 profiles (K {min(ks)}..{max(ks)}), 8 reads of "
                f"10 knt, planted K {[ks[i] for i in PFAM_PLANTED]}; host "
                f"set-up {took}")
        return self._db

    def largek(self):
        """The large-K profiles and reads (`workload.pfam_largek`)."""
        if self._big is None:
            from deciphon_tpu_torch.workload import LARGEK_KS, LARGEK_PLANTED

            self._big, took = self._host("largek")
            big_prof, big_seqs = self._big
            say("largek", f"{len(big_prof)} profiles K {list(LARGEK_KS)}, "
                f"{len(big_seqs)} reads of {big_seqs[0].size} nt, reads 0-2 "
                f"carrying (profile, nodes) {list(LARGEK_PLANTED)}; host "
                f"set-up {took}")
        return self._big

    def midk(self):
        """The mid-K profiles and reads (`workload.pfam_midk`)."""
        if self._mid is None:
            from deciphon_tpu_torch.workload import MIDK_PLANTED

            self._mid, took = self._host("midk")
            prof, seqs = self._mid
            say("midk", f"{len(prof)} profiles K "
                f"{[p.core_size for p in prof]}, {len(seqs)} reads of "
                f"{[q.size for q in seqs]} nt, reads 0-2 carrying (profile, "
                f"nodes) {list(MIDK_PLANTED)}; host set-up {took}")
        return self._mid

    def drop_scans(self) -> None:
        """Free the Scanners of phases 4-5d (their tables on the card)."""
        for k in ("pfam", "lr", "big", "mid"):
            self.__dict__.pop(k, None)


def phase_env(run: Run) -> None:
    torch = run.torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    say("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build(run: Run) -> None:
    from deciphon_tpu_torch import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    say("build", f"{lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            say("build", line.strip())

    report = run.report
    report.update({k: {"name": k, "route": "cuda", "source": SOURCE[k],
                       "replaces": REPLACES[k]} for k in SOURCE})
    for k, inst in ptxas_instances(_build.build_log).items():
        report[k]["ptxas"] = inst
        say("build", f"{k}: " + "; ".join(
            f"{i} {v['registers']} registers, {v['spill_stores']} B spill "
            f"stores" for i, v in inst.items()))
    check(all("ptxas" in r for r in report.values()),
          "the ptxas report lacks a kernel")


def phase_grid(run: Run) -> None:
    t0 = time.perf_counter()
    grid_full_width(run.torch, run.report, run.launches, run.side)
    say("grid", f"phase {time.perf_counter() - t0:.1f} s")


def phase_pfam(run: Run) -> None:
    """Phase 4: the Pfam scan on the packed route, the classic tiers and
    the unpacked route, with their ledger scans."""
    torch, launches = run.torch, run.launches
    from deciphon_tpu_torch.ops.tables import common_kp
    from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner
    from deciphon_tpu_torch.scan.scheduler import (BucketedPairScorer,
                                                   PackedPairScorer,
                                                   PairScorer)

    profiles, seqs = run.db()
    pfam = run.pfam = Scans(torch, profiles, seqs, "scan")
    scorers = pfam.scanner.scorer.scorers
    tbytes = sum(s.table_bytes() for s in scorers)
    classes = [(s.seg, s.nseg, s.Kp, len(s.inner.tables)) for s in scorers
               if isinstance(s, PackedPairScorer)]
    inner = sum(s.inner.table_bytes() for s in scorers
                if isinstance(s, PackedPairScorer))
    say("scan", f"{len(scorers)} scorers: packed classes (seg, nseg, Kp, "
        f"profiles) {classes}, plain buckets Kp "
        f"{[s.Kp for s in scorers if isinstance(s, PairScorer)]}; "
        f"{tbytes / 1e9:.3f} GB of tables on the card, of which the packed "
        f"classes' inner unpacked tables {inner / 1e9:.3f} GB")
    check(classes, "the default scorer formed no packed class")
    first, lines = pfam.counted(launches, ("pchain", "chain", "path", "walk"))
    say("scan", f"first scan of the process (cold): {first:.6f} s")
    m = pfam.scanner.metrics
    run.counters = {"windows": m.windows_scored, "cells": m.cells,
                    "survivors": m.survivors, "products": m.products}
    packed_med = pfam.warm_and_profile(lines)
    no_chain = {"DECIPHON_NO_CHAIN": "1"}
    classic, classic_lines = pfam.counted(
        launches, ("packed", "score", "path", "walk"), no_chain)
    check(classic_lines == lines,
          "DECIPHON_NO_CHAIN=1 wrote other products than the chain tiers")
    classic_walls = [classic]
    with environ(no_chain):
        for _ in range(2):
            w, again = pfam.scan()
            check(again == lines, "a classic-tier scan wrote other products")
            classic_walls.append(w)
    classic_med = statistics.median(classic_walls)
    # the bucket ledgers of both routes, on the warm Scanner
    run.pfam_ledger = pfam.ledger(lines)
    pfam.ledger(lines, no_chain)

    def unpacked(costs):
        """Plain buckets only, as the reference's custom-factory form."""
        return BucketedPairScorer(
            costs, "cuda", scorer_factory=lambda c: PairScorer(
                c, "cuda", w=BucketedPairScorer.plain_w(common_kp(c))))

    plain = Scans(torch, profiles, seqs, "scan, unpacked scorer",
                  scorer=unpacked)
    check(all(isinstance(s, PairScorer)
              for s in plain.scanner.scorer.scorers),
          "the custom factory did not keep the plain buckets")
    u0, unpacked_lines = plain.counted(launches, ("chain", "path", "walk"))
    check(unpacked_lines == lines,
          "the unpacked scorer wrote other products than the packed route")
    plain_med = plain.warm_and_profile(lines)
    say("scan", f"routes side by side, medians of 3 warm scans: packed "
        f"route (default) {packed_med:.6f} s, DECIPHON_NO_CHAIN=1 "
        f"{classic_med:.6f} s (walls {classic_walls}), unpacked scorer "
        f"{plain_med:.6f} s (its first scan {u0:.6f} s); products "
        "byte-identical")
    del plain
    fresh = Scanner(profiles, ScanConfig(device="cuda"))
    warm_s = fresh.warmup(read_lengths=[10000], reads_per_length=8)
    after, again = pfam.scan(fresh)
    check(again == lines, "the warmed-up scanner wrote other products")
    say("scan", f"fresh Scanner: warmup(read_lengths=[10000], "
        f"reads_per_length=8) {warm_s:.6f} s, then first scan {after:.6f} s "
        f"(the process's cold first scan {first:.6f} s)")
    del fresh
    run.lines, run.first, run.packed_med = lines, first, packed_med


def phase_long(run: Run) -> None:
    """Phase 5: the long-read scan, gang and carry over-cap tiers, with
    the ledger scans of both."""
    from deciphon_tpu_torch.workload import LONGREAD_PLANTED, pfam_longread

    profiles, _ = run.db()
    ks_db = [p.core_size for p in profiles]
    t0 = time.perf_counter()
    _, long_seqs = pfam_longread(profiles)
    say("long", f"3 reads of {long_seqs[0].size} nt, planted K "
        f"{[ks_db[i] for i in LONGREAD_PLANTED]} on reads 0-2; host set-up "
        f"{time.perf_counter() - t0:.1f} s")
    lr = run.lr = Scans(run.torch, profiles, long_seqs, "long")
    _, long_lines = lr.counted(run.launches, ("chain", "gang", "path",
                                              "walk"))
    hit_reads = {int(ln.split("\t")[0]) for ln in long_lines[1:]}
    say("long", f"products on reads {sorted(hit_reads)}")
    check({0, 1} <= hit_reads, "no survivors on the long-window reads 0/1")
    run.long_med = lr.warm_and_profile(long_lines, n_warm=1)
    seg = {"DECIPHON_CHAIN_SEG": "1"}
    _, seg_lines = lr.counted(run.launches, ("carry", "path", "walk"), seg)
    check(seg_lines == long_lines,
          "DECIPHON_CHAIN_SEG=1 wrote other products than the gang tier")
    say("long", "carry segments: products byte-identical to the gang tier's")
    lr.ledger(long_lines)
    lr.ledger(long_lines, seg)
    run.long_seqs, run.long_lines = long_seqs, long_lines


def phase_largek(run: Run) -> None:
    """Phase 5b: the large-K scan, B4 and B2 past 5120 lanes, and its
    ledger scan (the `_hbm` buckets)."""
    run.big, run.big_lines = largek_scan(run.torch, run.launches,
                                         run.largek())
    run.big.ledger(run.big_lines)


def phase_stream(run: Run) -> None:
    stream_scans(run.torch, run.report, run.launches, run.pfam, run.lr,
                 run.lines, run.long_lines, run.packed_med, run.long_med)


def midk_subset_run(dev: str, profiles=None) -> dict:
    """Phase 5d's card-against-CPU subset (`workload.midk_subset`: K 2100
    and 4608, buckets 2560 and 5120, two reads of 1.2 knt) on `dev`; the
    CPU's run goes to the side pool, which draws the mid-K profiles anew.
    Returns the products and the launch counts."""
    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner
    from deciphon_tpu_torch.workload import midk_subset, pfam_midk

    sub, seqs = midk_subset(pfam_midk()[0] if profiles is None
                            else profiles)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        vk.reset_launches()
        sc = Scanner(sub, ScanConfig(device=dev))
        kps = [s.Kp for s in sc.scorer.scorers]
        with open(sc.run(seqs, os.path.join(tmp, "p"))) as fp:
            text = fp.read()
    return dict(text=text, launches=dict(vk.LAUNCHES), kps=kps,
                products=sc.metrics.products,
                seconds=time.perf_counter() - t0,
                ks=[p.core_size for p in sub], sizes=[q.size for q in seqs])


def midk_shapes(vk, kps: list, keys: tuple) -> None:
    """Every launch of `keys` at the mid-K scorers' lane widths ran on a
    cluster: print its shape."""
    for key in keys:
        for Kp in kps:
            if (key, Kp) in vk.SHAPES:
                check(vk.SHAPES[(key, Kp)]["c"] > 1,
                      f"{key} at Kp {Kp} did not run on a cluster")
                say("midk", f"{key} at Kp {Kp}: {shape_note(vk, key, Kp)}")


def phase_midk(run: Run) -> None:
    """Phase 5d, the mid-K scan (`workload.pfam_midk`: two profiles in each
    plain bucket 2560..5120, B1, B3, B5 and B8 on clusters, six reads of 10
    and 24 knt): first scan counted, three warm scans and one profiled, its
    ledger scan; the same cell under DECIPHON_NO_CHAIN=1 (classic buckets:
    B1) and DECIPHON_CHAIN_SEG=1 (carry segments: B8), each counted,
    byte-identical to the default route's products; every score launch at
    its lane widths on a cluster; and the subset of K 2100 and 4608 on two
    reads of 1.2 knt on the card against the CPU (side pool)."""
    from deciphon_tpu_torch.ops import viterbi as vk

    t0 = time.perf_counter()
    torch, launches = run.torch, run.launches
    profiles, seqs = run.midk()
    mid = run.mid = Scans(torch, profiles, seqs, "midk")
    scorers = mid.scanner.scorer.scorers
    kps = [s.Kp for s in scorers]
    say("midk", f"{len(scorers)} plain buckets (Kp, w, profiles) "
        f"{[(s.Kp, s.w, len(s.tables)) for s in scorers]}; "
        f"{sum(s.table_bytes() for s in scorers) / 1e9:.3f} GB of tables")
    check(all(2048 < Kp <= vk.MAX_KP and not s.hbm_table
              for Kp, s in zip(kps, scorers)),
          "a mid-K profile left the plain buckets past Kp 2048")
    first, lines = mid.counted(launches, ("chain", "gang", "path", "walk"))
    say("midk", f"first scan of these tables (cold): {first:.6f} s")
    midk_shapes(vk, kps, ("chain", "gang", "score", "path"))
    hit_reads = {int(ln.split("\t")[0]) for ln in lines[1:]}
    say("midk", f"products on reads {sorted(hit_reads)}")
    check({0, 1, 2} <= hit_reads, "no products on a planted mid-K read")
    run.midk_med = mid.warm_and_profile(lines)
    run.mid_lines = lines
    mid.ledger(lines)
    for env, need in (({"DECIPHON_NO_CHAIN": "1"}, ("score", "path", "walk")),
                      ({"DECIPHON_CHAIN_SEG": "1"}, ("carry", "path",
                                                     "walk"))):
        _, again = mid.counted(launches, need, env)
        check(again == lines, f"{env}: other products than the default "
              "route's")
        midk_shapes(vk, kps, ("score", "chain", "carry"))
    say("midk", "DECIPHON_NO_CHAIN=1 and DECIPHON_CHAIN_SEG=1: products "
        "byte-identical to the default route's")
    outs = {"cuda": midk_subset_run("cuda", profiles),
            "cpu": side_result(run.side, ("midk subset",))}
    for dev, r in outs.items():
        say("midk", f"subset, {dev}: K {r['ks']} (Kp {r['kps']}) x reads of "
            f"{r['sizes']} nt, {r['products']} products, "
            f"{r['seconds']:.3f} s" + (" (side pool)" if dev == "cpu" else "")
            + f"; launches {r['launches']}")
    check(sum(outs["cpu"]["launches"].values()) == 0,
          "mid-K subset: the CPU's run launched a kernel")
    check(outs["cuda"]["text"] == outs["cpu"]["text"],
          "mid-K subset: card and CPU differ")
    check(outs["cuda"]["text"].count("\n") > 1, "mid-K subset: no products")
    say("midk", f"subset products.tsv byte-identical on card and CPU; phase "
        f"{time.perf_counter() - t0:.1f} s")


def phase_main_shapes(run: Run) -> None:
    """Phase 6: kernels against plain at the scans' own shapes."""
    t0 = time.perf_counter()
    no_chain = {"DECIPHON_NO_CHAIN": "1"}
    pfam_calls = run.pfam.captured(run.lines)
    nochain_calls = run.pfam.captured(run.lines, no_chain)
    long_calls = run.lr.captured(run.long_lines)
    seg_calls = run.lr.captured(run.long_lines, {"DECIPHON_CHAIN_SEG": "1"})
    big_calls = run.big.captured(run.big_lines)
    mid_calls = {}
    for env in ({}, no_chain, {"DECIPHON_CHAIN_SEG": "1"}):
        for k, v in run.mid.captured(run.mid_lines, env).items():
            mid_calls.setdefault(k, []).extend(v)
    run.drop_scans()
    midk = time_midk(run.torch, mid_calls)
    check_main_shapes(run.torch, run.report, pfam_calls, nochain_calls,
                      long_calls, seg_calls, big_calls, run.card, midk)
    midk_plain(run.torch, run.report, run.card, midk)
    del pfam_calls, nochain_calls, long_calls, seg_calls, big_calls
    del mid_calls, midk
    say("main", f"phase {time.perf_counter() - t0:.1f} s")


# Phase 7's card-against-CPU scans of the subset: (label, environment,
# table budget, kernel that must launch on the card, kernel that must not)
SUBSET_RUNS = (("reference caps", {}, None, None, None),
               ("caps 4, gang", {}, None, "gang", "gang_large"),
               ("caps 4, carry", {"DECIPHON_CHAIN_SEG": "1"}, None, "carry",
                "gang"),
               ("caps 4, gang, streamed", {}, 1, "gang_large", "gang"))


def subset_run(i: int, dev: str) -> dict:
    """One of phase 7's subset scans (SUBSET_RUNS[i]) on `dev`: the Pfam
    subset (`workload.pfam_subset()`), at the reference's caps or on
    plain buckets with the chain caps shrunk to 4 and a 150-nt read
    added (so that its 1.2-knt windows are over the cap and ride the gang
    or the carry segments).  Returns the products, the launch counts and
    what the card's run must show; the CPU's run goes to the side pool."""
    import numpy as np

    from deciphon_tpu_torch.ops import viterbi as vk
    from deciphon_tpu_torch.ops.tables import common_kp
    from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner
    from deciphon_tpu_torch.scan.scheduler import (BucketedPairScorer,
                                                   PairScorer)
    from deciphon_tpu_torch.scan.sequence import Sequence
    from deciphon_tpu_torch.workload import pfam_subset, random_bases

    label, env, budget, must, _ = SUBSET_RUNS[i]
    sub_prof, sub_seqs = pfam_subset()
    shrink = must is not None
    caps = (PairScorer.CHAIN_MAX_BLK, PairScorer.NLB_FLOOR)

    def plain_buckets(costs):
        """Plain buckets only: the subset's profiles would all pack, and
        whole-read windows of a packed class never reach the gang or the
        carry segments."""
        return BucketedPairScorer(
            costs, dev, hbm_budget=budget, scorer_factory=lambda c:
            PairScorer(c, dev, w=BucketedPairScorer.plain_w(common_kp(c))))

    # with the caps shrunk, a 150-nt read pins a chain cap of 4 blocks, so
    # that the 1.2-knt windows are over it and ride the gang (or carry)
    short = Sequence.make(len(sub_seqs), "s2", random_bases(
        np.random.default_rng(9), 150))
    reads = sub_seqs + [short] if shrink else sub_seqs
    if shrink:
        PairScorer.CHAIN_MAX_BLK = PairScorer.NLB_FLOOR = 4
    t0 = time.perf_counter()
    try:
        with environ(env), tempfile.TemporaryDirectory() as tmp:
            vk.reset_launches()
            sc = Scanner(sub_prof, ScanConfig(device=dev),
                         scorer=plain_buckets if shrink else None)
            with open(sc.run(reads, os.path.join(tmp, "p"))) as fp:
                text = fp.read()
    finally:
        PairScorer.CHAIN_MAX_BLK, PairScorer.NLB_FLOOR = caps
    return dict(text=text, launches=dict(vk.LAUNCHES),
                products=sc.metrics.products, seconds=time.perf_counter() - t0,
                profiles=len(sub_prof), sizes=[q.size for q in reads],
                resident=bool(sc.scorer.ledger.resident) if shrink else None)


def torch_engine_job(want: str) -> dict:
    """Phase 7's torch-engine check (torch_engine_subset) in a process of
    its own on the card, beside phase 11: returns its launch counts."""
    import torch

    from deciphon_tpu_torch.workload import pfam_subset

    launches: dict = {}
    torch_engine_subset(torch, *pfam_subset(), want, launches)
    return launches


def largek_subset_run(dev: str, big_prof=None) -> dict:
    """Phase 7, large-K: the first two large-K profiles (K 5200, 5300) on
    two reads of 2 knt on `dev` (the CPU's run goes to the side pool,
    which draws the large-K profiles anew)."""
    from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner
    from deciphon_tpu_torch.workload import largek_subset, pfam_largek

    sub, seqs = largek_subset(pfam_largek()[0] if big_prof is None
                              else big_prof)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sc = Scanner(sub, ScanConfig(device=dev))
        tier = all(s.hbm_table for s in sc.scorer.scorers)
        with open(sc.run(seqs, os.path.join(tmp, "p"))) as fp:
            text = fp.read()
    return dict(text=text, tier=tier, products=sc.metrics.products,
                seconds=time.perf_counter() - t0,
                ks=[p.core_size for p in sub], reads=len(seqs),
                size=seqs[0].size)


def phase_subset(run: Run) -> None:
    """Phase 7: card against CPU on the same code (the CPU's scans ran in
    the side pool, submitted when the script started)."""
    from deciphon_tpu_torch.workload import pfam_subset

    for i, (label, env, budget, must, never) in enumerate(SUBSET_RUNS):
        outs = {"cuda": subset_run(i, "cuda"),
                "cpu": side_result(run.side, ("subset", i))}
        for dev, r in outs.items():
            say("subset", f"{label}, {dev}: {r['profiles']} profiles x "
                f"{len(r['sizes'])} reads of {r['sizes']} nt, "
                f"{r['products']} products, {r['seconds']:.3f} s"
                + (" (side pool)" if dev == "cpu" else "")
                + f"; launches {r['launches']}")
        got = outs["cuda"]
        if must is not None:
            check(got["launches"][must] > 0 and got["launches"][never] == 0,
                  f"{label}: {must} did not launch, or {never} did")
            check(budget is None or not got["resident"],
                  f"{label}: a scorer stayed resident")
        check(sum(outs["cpu"]["launches"].values()) == 0,
              f"{label}: the CPU's run launched a kernel")
        check(got["text"] == outs["cpu"]["text"],
              f"{label}: card and CPU differ")
        check(got["text"].count("\n") > 1, f"{label}: no products")
        if must is None:
            run.subset_bytes = got["text"]
    if not run.engine_later:
        sub_prof, sub_seqs = pfam_subset(run.db()[0])
        torch_engine_subset(run.torch, sub_prof, sub_seqs, run.subset_bytes,
                            run.launches)
    outs = {"cuda": largek_subset_run("cuda", run.largek()[0]),
            "cpu": side_result(run.side, ("largek subset",))}
    for dev, r in outs.items():
        check(r["tier"], "the large-K subset left the large-K tier")
        say("subset", f"large-K, {dev}: K {r['ks']} x {r['reads']} reads of "
            f"{r['size']} nt, {r['products']} products, {r['seconds']:.3f} s"
            + (" (side pool)" if dev == "cpu" else ""))
    check(outs["cuda"]["text"] == outs["cpu"]["text"],
          "large-K subset: card and CPU differ")
    check(outs["cuda"]["text"].count("\n") > 1, "large-K subset: no products")
    say("subset", "products.tsv byte-identical on card and CPU")


def phase_confirm(run: Run) -> None:
    from deciphon_tpu_torch.workload import pfam_subset

    profiles, seqs = run.db()
    confirm_phase(run.torch, run.report, run.launches, profiles, seqs,
                  run.lines, run.packed_med, *pfam_subset(profiles), run.side)


def phase_cli(run: Run) -> None:
    run.cli = cli_phase(run.torch, run.launches, run.cli_tmp, run.side)


def phase_multi(run: Run) -> None:
    multi_phase(run.torch, run.launches, dict(
        profiles=run.db()[0], seqs=run.db()[1], lines=run.lines,
        first=run.first, med=run.packed_med, counters=run.counters,
        long_seqs=run.long_seqs, long_lines=run.long_lines,
        big_prof=run.largek()[0], big_seqs=run.largek()[1],
        big_lines=run.big_lines, ledger=run.pfam_ledger,
        dry=getattr(run, "dry", None)))


def phase_services(run: Run) -> None:
    services_phase(run.torch, run.launches, run.cli)


def phase_entry(run: Run) -> None:
    entry_phase(run.torch, run.launches, run)


RUNNERS = {"1": phase_env, "2": phase_build, "3": None, "3b": phase_grid,
           "4": phase_pfam, "5": phase_long, "5b": phase_largek,
           "5c": phase_stream, "5d": phase_midk, "6": phase_main_shapes,
           "7": phase_subset,
           "8": phase_confirm, "9": phase_cli, "10": phase_multi,
           "11": phase_services, "12": phase_entry}


def submit_side_jobs(run: Run, phases: list, late: bool) -> None:
    """Hand the pools their jobs, in the order the phases read them: once
    the kernels are built (`late` false), phase 3's plain versions to the
    card pool and the scans' host data to the side pool; the rest (phase
    7's and 8's CPU scans and phase 9's press) once the scans that time
    the host (phases 4-5c) are behind."""
    side = run.side
    if late:
        submit_late_jobs(run, phases)
        return
    if "3" in phases:
        for case in cases3():
            run.card.submit(("plain", case), card_plain3, case)
    if "3b" in phases:
        for K, _ in GRID_SHAPES:
            side.submit(("grid costs", K), side_job, grid_costs, K)
    if set(phases) & set(DB_PHASES):
        side.submit(("db",), side_job, host_data, "db")
    if set(phases) & set(LARGEK_PHASES):
        side.submit(("largek",), side_job, host_data, "largek")
    if set(phases) & set(MIDK_PHASES):
        side.submit(("midk",), side_job, host_data, "midk")
        side.submit(("midk subset",), side_job, midk_subset_run, "cpu")


def submit_late_jobs(run: Run, phases: list) -> None:
    side = run.side
    if "7" in phases:
        for i in range(len(SUBSET_RUNS)):
            side.submit(("subset", i), side_job, subset_run, i, "cpu")
        side.submit(("largek subset",), side_job, largek_subset_run, "cpu")
    if "8" in phases:
        for label in ("Pfam subset", "confirm_case"):
            for r in ("cpu", "cpu f64"):
                side.submit(("confirm", label, r), side_job,
                            confirm_subset_run, label, r)
    if "9" in phases:
        side.submit(("press",), side_job, cli_press, run.cli_tmp)


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", help="run these phases (and the ones they "
                    "need), e.g. 1-6,12; default: every phase")
    args = ap.parse_args()
    check(torch.cuda.is_available(), "no CUDA device")
    check(os.path.isdir(os.path.join(HERE, "deciphon_tpu_torch")),
          "run from the root of a deciphon-tpu checkout")
    sys.path.insert(0, HERE)
    phases = select_phases(args.phases)
    whole = phases == list(PHASES)
    say("phases", "running every phase" if whole else
        f"--phases {args.phases}: running {phases} (the named phases, the "
        "ones they need, and 1-2)")
    run = Run(torch, Side())
    run.phases = phases
    # the card pool: phases 3's and 6's plain versions, beside this process
    run.card = Side(CARD_WORKERS, card=True) if {"3", "6"} & set(phases) \
        else None
    run.cli_tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    # the last phase that uses the Scanners of phases 4-5b
    scanning = [p for p in phases if p in ("4", "5", "5b", "5c", "5d", "6")]
    # phase 7's torch engine, launch-bound for a minute, runs in a process
    # of its own on the card beside phase 11 where both run (its walk
    # launches count there), else within phase 7
    run.engine_later = "7" in phases and "11" in phases
    try:
        for p in phases:
            before = dict(run.launches)
            if p == "11" and run.engine_later:
                run.engine = Side(1, card=True)
                run.engine.submit(("torch engine",), side_job,
                                  torch_engine_job, run.subset_bytes)
            if p in ("6", "7", "8", "9") and not getattr(run, "late", False):
                submit_side_jobs(run, phases, late=True)
                run.late = True
            if p == "9" and "10" in phases:
                run.dry = DryRun("with phase 9, beside it")
            if p == "3":
                check_kernels(torch, run.report, run.card)
            else:
                RUNNERS[p](run)
            if p == "2":  # the pools start once nvcc is done
                submit_side_jobs(run, phases, late=False)
            if p == "11" and run.engine_later:
                for k, v in side_result(run.engine,
                                        ("torch engine",)).items():
                    run.launches[k] = run.launches.get(k, 0) + v
                run.engine.close()
            for k in PHASE_KERNELS.get(p, ()):
                if p == "7" and run.engine_later and k == "walk":
                    continue  # its torch engine runs beside phase 11
                check(run.launches.get(k, 0) > before.get(k, 0),
                      f"kernel {k} never launched on phase {p}'s paths")
            if scanning and p == scanning[-1]:
                run.drop_scans()
            if p != "1":
                elapsed(p)
    finally:
        import shutil

        if getattr(run, "dry", None) is not None:
            run.dry.cleanup()
        if getattr(run, "engine", None) is not None:
            run.engine.close()
        if run.card is not None:
            run.card.close()
        run.side.close()
        shutil.rmtree(run.cli_tmp, ignore_errors=True)
    say("side", f"the card's process waited {run.side.waited:.1f} s in all "
        "for the side pool")
    check(not [m for m in sys.modules
               if m.split(".")[0] in ("jax", "deciphon_tpu")],
          "jax or deciphon_tpu was imported")

    from deciphon_tpu_torch.ops import viterbi as vk

    report = run.report
    launched = {k for p in phases for k in PHASE_KERNELS.get(p, ())}
    timed = {k for p in phases for k in PHASE_TIMED.get(p, ())}
    if whole:
        check(launched == timed == set(SOURCE),
              "PHASE_KERNELS or PHASE_TIMED leaves a kernel out")
    else:
        say("phases", f"a selection ran ({phases}): the closing checks cover "
            f"only the kernels its phases launch {sorted(launched)} and "
            f"time {sorted(timed)}, and the kernels line lists those")
    # the wrappers that keep their launch shapes
    for k in ("score", "chain", "gang", "carry", "large", "gang_large",
              "path", "grid", "packed", "pchain"):
        report[k]["shapes"] = {str(Kp): sh for (key, Kp), sh
                               in sorted(vk.SHAPES.items()) if key == k}
    for k, r in report.items():
        r["launches"] = run.launches.get(k, 0)
        check(k not in launched or r["launches"] > 0,
              f"kernel {k} never launched on a scan path")
        check(k not in timed or "us_per_position" in r,
              f"kernel {k} has no time per position")
    print(json.dumps({"kernels": [r for k, r in report.items()
                                  if k in launched | timed]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
