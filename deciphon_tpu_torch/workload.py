"""Seeded synthetic workloads for the port's tests and chip_smoke.py.

* `pfam_ks` — Pfam-shaped ragged core sizes, geometric over [50, 2000]
  (the rule of bench.py's scan workload).
* `planted_read` — a read that carries one profile's domain: the per-node
  argmax codon of `FrameProfile.match_codon_lprobs`, optionally with
  substitution and indel noise, embedded in uniform random bases.  Such
  reads survive the LRT filter, so phase 2 (trellis, traceback, decode)
  has real work without external data.
* `window_batch` / `score_inputs` — kernel inputs of one bucket;
  `chain_inputs`, `chain_case`, `mixed_case`, `carry_case` (with
  `run_carry_calls`) those of the chain, gang and carry modes,
  `packed_case`, `packed_chain_inputs` and `packed_chain_case` those of
  the lane-packed modes, and `window_scores` the same windows scored
  alone by B1.
* `pfam_scan` / `pfam_subset` / `pfam_longread` / `pfam_midk` /
  `midk_subset` / `pfam_largek` / `largek_subset` — chip_smoke.py's scans
  and its card-against-CPU subsets; `sample_hmm` / `pfam_scan_hmms` — the
  amino profiles (HMMER3 form, with a FORWARD calibration) that those
  frame profiles were pressed from, for the confirmer; `peaked_hmm` /
  `confirm_case` — profiles and reads whose hits the confirmer both keeps
  and drops; `exact_confirmer`
  — the confirmer on the plain versions in f64; `amino_hits` — a batch
  of hits for the amino Forward and posterior kernels; `hmm_text` — the
  HMMER3/f text of amino profiles, for `press` and the CLI.
* `walk_cases` — trellises planted with the traceback walk's edge cases.
"""

from __future__ import annotations

import numpy as np

from .profile import FrameProfile

BASES = "ACGT"


def pfam_ks(n: int, lo: int = 50, hi: int = 2000) -> list[int]:
    if n <= 0:
        return []
    if n == 1:
        return [400]
    return [int(round(lo * (hi / lo) ** (i / (n - 1)))) for i in range(n)]


def domain_bases(profile: FrameProfile, nodes: tuple[int, int] | None = None
                 ) -> str:
    """The argmax codon of every core node, concatenated (3K bases), or of
    the nodes [a, b) only."""
    a, b = nodes or (0, profile.core_size)
    best = profile.match_codon_lprobs[a:b].reshape(b - a, 64).argmax(axis=1)
    return "".join(BASES[c >> 4] + BASES[(c >> 2) & 3] + BASES[c & 3]
                   for c in best)


def random_bases(rng: np.random.Generator, n: int) -> str:
    return "".join(BASES[b] for b in rng.integers(0, 4, size=n))


def mutate(rng: np.random.Generator, bases: str, rate: float) -> str:
    """Per base: substitution, insertion or deletion, each with
    probability rate / 3."""
    if rate <= 0:
        return bases
    out = []
    for b in bases:
        u = rng.random()
        if u < rate / 3:
            out.append(BASES[rng.integers(0, 4)])
        elif u < 2 * rate / 3:
            out.append(b + BASES[rng.integers(0, 4)])
        elif u < rate:
            continue
        else:
            out.append(b)
    return "".join(out)


def window_batch(rng: np.random.Generator, lens: np.ndarray,
                 device="cpu", multi_hits: bool = True,
                 hmmer3_compat: bool = False) -> dict:
    """Per-window kernel inputs of one bucket: every slot with lens > 0
    scans a fresh random read of that length; slots of length 0 are pads.
    Returns tensors xts (N, W, 16), lengths (N, W, 1), starts (N, W) and
    the code table codes_all (T, 5) on `device`."""
    import torch

    from .scan.sequence import Sequence
    from .xtrans import xtrans_cost_vector

    from .scan.scheduler import DeviceSeqCodes

    lens = np.asarray(lens, np.int32)
    real = lens > 0
    seqs = [Sequence.make(i, f"s{i}", random_bases(rng, int(n)))
            for i, n in enumerate(lens[real])]
    codes = DeviceSeqCodes(seqs, device)
    starts = np.full(lens.shape, codes.pad_start, np.int32)
    starts[real] = codes.offsets
    xts = np.zeros(lens.shape + (16,), np.float32)
    for idx in zip(*np.nonzero(real)):
        xts[idx][:13] = xtrans_cost_vector(multi_hits, hmmer3_compat,
                                           int(lens[idx]))
    return dict(xts=torch.from_numpy(xts).to(device),
                lengths=torch.from_numpy(lens[..., None].copy()).to(device),
                starts=torch.from_numpy(starts).to(device),
                codes_all=codes.dev)


def score_inputs(Kp: int, w: int, n_pairs: int, lo: int, hi: int,
                 seed: int, device="cpu") -> tuple[dict, int]:
    """Kernel inputs of one bucket at lane width Kp: n_pairs pairs of w
    windows of lo..hi nt over random reads, scored against two profiles
    (K = Kp - 2 and Kp // 2) in turn.  Returns (the kernels' keyword
    arguments, the longest window)."""
    import torch

    from .ops.costs import build_costs
    from .profile import sample_profile

    from .ops.tables import stack_tables

    rng = np.random.default_rng(seed)
    costs = [build_costs(sample_profile(seed + i, k))
             for i, k in enumerate((Kp - 2, Kp // 2))]
    tables, tvecs = (t.to(device) for t in stack_tables(costs, Kp))
    lens = rng.integers(lo, hi + 1, size=(n_pairs, w))
    pidx = torch.tensor(np.arange(n_pairs) % 2, dtype=torch.int32,
                        device=device)
    return dict(pidx=pidx, tables=tables, tvecs=tvecs,
                **window_batch(rng, lens, device)), int(lens.max())


def chain_inputs(codes, pairs, n_pairs: int, cmax: int, w: int = 8,
                 multi_hits: bool = True,
                 hmmer3_compat: bool = False) -> dict:
    """Chain metadata of the B3/B8 kernels for explicit window chains.

    `codes` is a DeviceSeqCodes; `pairs` lists (profile index, chains),
    chains[w] being slot w's windows as (start, stop) rows of
    `codes.dev`, packed back to back at KAPPA-position blocks.  Pairs
    past len(pairs) up to `n_pairs` and entries past each chain are pads
    (length 0).  Returns the B3 wrapper's keyword arguments but the
    tables, on the codes' device: pidx (N,), win_sblk, win_len,
    win_gstart, win_xti (N, w, cmax) int32, the xtrans LUT xt_lut (X, 16)
    f32 (one row per distinct window length) and codes_all."""
    import torch

    from .xtrans import xtrans_cost_vector

    from .ops.viterbi import KAPPA

    shape = (n_pairs, w, cmax)
    sblk = np.zeros(shape, np.int32)
    wlen = np.zeros(shape, np.int32)
    gst = np.full(shape, codes.pad_start, np.int32)
    xti = np.zeros(shape, np.int32)
    pidx = np.zeros((n_pairs,), np.int32)
    rows: dict[int, int] = {}
    for n, (p, chains) in enumerate(pairs):
        pidx[n] = p
        for s, chain in enumerate(chains):
            blk = 0
            for c, (a, b) in enumerate(chain):
                sblk[n, s, c] = blk
                wlen[n, s, c] = b - a
                gst[n, s, c] = a
                xti[n, s, c] = rows.setdefault(b - a, len(rows))
                blk += -(-(b - a) // KAPPA)
    lut = np.zeros((max(16, len(rows)), 16), np.float32)
    for length, r in rows.items():
        lut[r, :13] = xtrans_cost_vector(multi_hits, hmmer3_compat, length)
    dev = codes.dev.device
    out = dict(pidx=pidx, win_sblk=sblk, win_len=wlen, win_gstart=gst,
               win_xti=xti, xt_lut=lut)
    return dict({k: torch.from_numpy(v).to(dev) for k, v in out.items()},
                codes_all=codes.dev)


def random_chains(rng: np.random.Generator, n_slots: int, cmax: int,
                  lo: int, hi: int, read_len: int) -> list:
    """n_slots chains of 1..cmax random windows of lo..hi nt inside one
    read of read_len nt, as (start, stop) rows for `chain_inputs`."""
    chains = []
    for _ in range(n_slots):
        chain = []
        for _ in range(int(rng.integers(1, cmax + 1))):
            n = int(rng.integers(lo, hi + 1))
            a = int(rng.integers(0, read_len - n + 1))
            chain.append((a, a + n))
        chains.append(chain)
    return chains


def _random_db(rng, Ks, Kp, n_bases, device):
    """Tables of sample profiles with core sizes Ks at lane width Kp, and
    a DeviceSeqCodes of one random read of n_bases nt."""
    from .ops.costs import build_costs
    from .profile import sample_profile
    from .scan.sequence import Sequence

    from .ops.tables import stack_tables
    from .scan.scheduler import DeviceSeqCodes

    seed = int(rng.integers(1 << 20))
    costs = [build_costs(sample_profile(seed + i, k)) for i, k in
             enumerate(Ks)]
    tables, tvecs = (t.to(device) for t in stack_tables(costs, Kp))
    read = Sequence.make(0, "r0", random_bases(rng, n_bases))
    return tables, tvecs, DeviceSeqCodes([read], device)


def chain_case(Kp: int, seed: int, device="cpu", n_pairs: int = 3,
               cmax: int = 4, lo: int = 100, hi: int = 1000) -> dict:
    """B3 kernel check at lane width Kp: n_pairs pairs of 8 slots, each a
    chain of 1..cmax random windows of lo..hi nt over one random read,
    against two profiles (K = Kp - 2 and Kp // 2), plus one all-pad
    pair.  Returns the B3 wrapper's keyword arguments."""
    rng = np.random.default_rng(seed)
    tables, tvecs, codes = _random_db(rng, (Kp - 2, Kp // 2), Kp, 20_000,
                                      device)
    pairs = [(n % 2, random_chains(rng, 8, cmax, lo, hi, 20_000))
             for n in range(n_pairs)]
    return dict(tables=tables, tvecs=tvecs,
                **chain_inputs(codes, pairs, n_pairs + 1, cmax))


def mixed_case(Kp: int, seed: int, device="cpu", n_pairs: int = 2,
               w: int = 16, lo: int = 100, hi: int = 2000) -> dict:
    """B5 kernel check at lane width Kp: n_pairs pairs of w windows of
    lo..hi nt over one random read, three profiles (K = Kp - 2, Kp // 2,
    Kp // 3) interleaved over the slots, one slot of each pair a pad.
    Returns the B5 wrapper's keyword arguments."""
    import torch

    from .xtrans import xtrans_cost_vector

    rng = np.random.default_rng(seed)
    tables, tvecs, codes = _random_db(rng, (Kp - 2, Kp // 2, Kp // 3), Kp,
                                      20_000, device)
    lens = rng.integers(lo, hi + 1, size=(n_pairs, w)).astype(np.int32)
    lens[:, -1] = 0
    starts = np.array([[int(rng.integers(0, 20_000 - n + 1)) for n in row]
                       for row in lens], np.int32)
    starts[lens == 0] = codes.pad_start
    pidx = (np.arange(n_pairs * w).reshape(n_pairs, w) % 3).astype(np.int32)
    xts = np.zeros((n_pairs, w, 16), np.float32)
    for n, i in zip(*np.nonzero(lens)):
        xts[n, i, :13] = xtrans_cost_vector(True, False, int(lens[n, i]))
    host = dict(pidx=pidx, xts=xts, lengths=lens[..., None].copy(),
                starts=starts)
    return dict({k: torch.from_numpy(v).to(device) for k, v in host.items()},
                tables=tables, tvecs=tvecs, codes_all=codes.dev)


def carry_case(Kp: int, seed: int, device="cpu", cap: int = 4,
               n_blocks: int = 13) -> dict:
    """B8 kernel check at lane width Kp: one random window of n_blocks
    KAPPA-blocks (its last block partial) split into cap-block segments
    over consecutive calls, with a normal window of at most cap blocks (as
    the scheduler packs them) riding in slot 1 of each call (W = 8,
    C = 2).  Returns dict(tables, tvecs, codes_all, xt_lut,
    calls: the per-call metadata (pidx, win_sblk, win_len, win_gstart,
    win_xti, conts and the carry route), whole: the (start, stop) of the
    segmented window, rides: the riding windows)."""
    import torch

    from .xtrans import xtrans_cost_vector

    from .ops.viterbi import CW, KAPPA

    rng = np.random.default_rng(seed)
    tables, tvecs, codes = _random_db(rng, (Kp - 2,), Kp, 20_000, device)
    total = n_blocks * KAPPA - 7
    a0 = int(rng.integers(0, 20_000 - total))
    nsegs = -(-n_blocks // cap)
    rides = []
    lut = np.zeros((16, 16), np.float32)
    lut[0, :13] = xtrans_cost_vector(True, False, total)
    calls = []
    for t in range(nsegs):
        shape = (1, 8, 2)
        sblk = np.zeros(shape, np.int32)
        wlen = np.zeros(shape, np.int32)
        gst = np.full(shape, codes.pad_start, np.int32)
        xti = np.zeros(shape, np.int32)
        conts = np.zeros((1, 8), np.int32)
        wlen[0, 0, 0] = (cap * KAPPA if t < nsegs - 1
                         else total - (nsegs - 1) * cap * KAPPA)
        gst[0, 0, 0] = a0 + t * cap * KAPPA
        conts[0, 0] = int(t > 0)
        n = int(rng.integers(50, cap * KAPPA + 1))  # rides fit the cap
        a = int(rng.integers(0, 20_000 - n))
        rides.append((a, a + n))
        wlen[0, 1, 0] = n
        gst[0, 1, 0] = a
        xti[0, 1, 0] = 1 + t
        lut[1 + t, :13] = xtrans_cost_vector(True, False, n)
        host = dict(pidx=np.zeros((1,), np.int32), win_sblk=sblk,
                    win_len=wlen, win_gstart=gst, win_xti=xti, conts=conts,
                    route=np.arange(CW, dtype=np.int32))
        calls.append({k: torch.from_numpy(v).to(device)
                      for k, v in host.items()})
    return dict(tables=tables, tvecs=tvecs, codes_all=codes.dev,
                xt_lut=torch.from_numpy(lut).to(device), calls=calls,
                whole=(a0, a0 + total), rides=rides)


def run_carry_calls(fn, case: dict) -> list:
    """Run a `carry_case` through fn (`scores_pairs_chained_carry` or its
    plain version), routing each call's exported planes into the next
    call with `carry_permute`.  Returns each call's (alt, null, cbig,
    csml)."""
    import torch

    from .ops.viterbi import CW, carry_permute

    Kp = case["tables"].shape[2]
    dev = case["tables"].device
    out = []
    for call in case["calls"]:
        meta = {k: v for k, v in call.items() if k != "route"}
        if out:
            cbig, csml = carry_permute(out[-1][2], out[-1][3], call["route"])
        else:
            cbig = torch.zeros((1, 13, CW, Kp), device=dev)
            csml = torch.zeros((1, 32, CW, 1), device=dev)
        out.append(fn(tables=case["tables"], tvecs=case["tvecs"],
                      cbig_in=cbig, csml_in=csml, xt_lut=case["xt_lut"],
                      codes_all=case["codes_all"], **meta))
    return out


def _packed_db(rng, Ks, seg, nseg, n_bases, device):
    """Packed tables of sample profiles with core sizes Ks (packs of nseg
    segments of seg lanes), and a DeviceSeqCodes of one random read."""
    from .ops.costs import build_costs
    from .ops.tables import stack_tables_packed
    from .profile import sample_profile
    from .scan.scheduler import DeviceSeqCodes
    from .scan.sequence import Sequence

    seed = int(rng.integers(1 << 20))
    costs = [build_costs(sample_profile(seed + i, k)) for i, k in
             enumerate(Ks)]
    tables, tvecs = (t.to(device) for t in
                     stack_tables_packed(costs, seg, nseg))
    read = Sequence.make(0, "r0", random_bases(rng, n_bases))
    return tables, tvecs, DeviceSeqCodes([read], device)


def _packed_ks(seg: int, nseg: int) -> list[int]:
    """Core sizes of two packs of nseg segments of seg lanes: the first
    full (its widest profile K = seg - 2), the second missing its last
    segment."""
    full = [max(seg // 2, seg - 2 - 3 * i) for i in range(nseg)]
    return full + [max(seg // 2 - 1, seg - 9 - 5 * i)
                   for i in range(nseg - 1)]


def packed_case(seg: int, nseg: int, seed: int, device="cpu",
                n_pairs: int = 3, w: int = 16, lo: int = 100,
                hi: int = 2000) -> dict:
    """B6 kernel check on a plane of nseg segments of seg lanes: n_pairs
    pairs of w windows of lo..hi nt over one random read, against two
    packs in turn (the second with its last segment missing), one slot of
    each pair a pad.  Returns the B6 wrapper's keyword arguments."""
    import torch

    from .xtrans import xtrans_cost_vector

    rng = np.random.default_rng(seed)
    tables, tvecs, codes = _packed_db(rng, _packed_ks(seg, nseg), seg, nseg,
                                      20_000, device)
    lens = rng.integers(lo, hi + 1, size=(n_pairs, w)).astype(np.int32)
    lens[:, -1] = 0
    starts = np.array([[int(rng.integers(0, 20_000 - n + 1)) for n in row]
                       for row in lens], np.int32)
    starts[lens == 0] = codes.pad_start
    xts = np.zeros((n_pairs, w, 16), np.float32)
    for n, i in zip(*np.nonzero(lens)):
        xts[n, i, :13] = xtrans_cost_vector(True, False, int(lens[n, i]))
    host = dict(pidx=(np.arange(n_pairs) % 2).astype(np.int32), xts=xts,
                lengths=lens[..., None].copy(), starts=starts)
    return dict({k: torch.from_numpy(v).to(device) for k, v in host.items()},
                tables=tables, tvecs=tvecs, codes_all=codes.dev, nseg=nseg)


def packed_chain_inputs(codes, pairs, n_pairs: int, cmax: int, nseg: int,
                        w: int = 8, multi_hits: bool = True,
                        hmmer3_compat: bool = False) -> dict:
    """Chain metadata of the B7 kernel as the scheduler lays it out: the
    window chains of `chain_inputs` are each slot's code runs, and every
    segment lists them as its windows.  Returns the B7 wrapper's keyword
    arguments but the tables and nseg."""
    m = chain_inputs(codes, pairs, n_pairs, cmax, w, multi_hits,
                     hmmer3_compat)

    def per_seg(a):
        return a[:, :, None, :].expand(-1, -1, nseg, -1).contiguous()

    return dict(pidx=m["pidx"], run_sblk=m["win_sblk"], run_len=m["win_len"],
                run_gstart=m["win_gstart"], win_sblk=per_seg(m["win_sblk"]),
                win_len=per_seg(m["win_len"]), win_xti=per_seg(m["win_xti"]),
                xt_lut=m["xt_lut"], codes_all=m["codes_all"])


def packed_chain_case(seg: int, nseg: int, seed: int, device="cpu",
                      n_pairs: int = 3, cmax: int = 4, lo: int = 100,
                      hi: int = 1000, per_segment: bool = False) -> dict:
    """B7 kernel check on a plane of nseg segments of seg lanes: n_pairs
    pairs of 8 slots against two packs in turn, plus one all-pad pair.
    Shared lists (the scheduler's case): each slot a chain of 1..cmax
    random windows of lo..hi nt, listed by every segment.  With
    `per_segment`, each slot is one run of cmax * hi nt and every segment
    cuts it into its own 1..cmax consecutive block-aligned windows.
    Returns the B7 wrapper's keyword arguments."""
    import torch

    from .ops.viterbi import KAPPA
    from .xtrans import xtrans_cost_vector

    rng = np.random.default_rng(seed)
    tables, tvecs, codes = _packed_db(rng, _packed_ks(seg, nseg), seg, nseg,
                                      20_000, device)
    if not per_segment:
        pairs = [(n % 2, random_chains(rng, 8, cmax, lo, hi, 20_000))
                 for n in range(n_pairs)]
        return dict(tables=tables, tvecs=tvecs, nseg=nseg,
                    **packed_chain_inputs(codes, pairs, n_pairs + 1, cmax,
                                          nseg))
    N, W = n_pairs + 1, 8
    run_blocks = -(-cmax * hi // KAPPA)
    run_sblk = np.zeros((N, W, 1), np.int32)
    run_len = np.zeros((N, W, 1), np.int32)
    run_gst = np.full((N, W, 1), codes.pad_start, np.int32)
    wsb = np.zeros((N, W, nseg, cmax), np.int32)
    wln = np.zeros((N, W, nseg, cmax), np.int32)
    wxt = np.zeros((N, W, nseg, cmax), np.int32)
    rows: dict[int, int] = {}
    for n in range(n_pairs):
        for wi in range(W):
            run_len[n, wi, 0] = run_blocks * KAPPA
            run_gst[n, wi, 0] = int(rng.integers(
                0, 20_000 - run_blocks * KAPPA))
            for s in range(nseg):
                blk = 0
                for c in range(int(rng.integers(1, cmax + 1))):
                    length = int(rng.integers(lo, hi + 1))
                    wsb[n, wi, s, c] = blk
                    wln[n, wi, s, c] = length
                    wxt[n, wi, s, c] = rows.setdefault(length, len(rows))
                    blk += -(-length // KAPPA)
    lut = np.zeros((max(16, len(rows)), 16), np.float32)
    for length, r in rows.items():
        lut[r, :13] = xtrans_cost_vector(True, False, length)
    host = dict(pidx=(np.arange(N) % 2).astype(np.int32), run_sblk=run_sblk,
                run_len=run_len, run_gstart=run_gst, win_sblk=wsb,
                win_len=wln, win_xti=wxt, xt_lut=lut)
    return dict({k: torch.from_numpy(v).to(device) for k, v in host.items()},
                tables=tables, tvecs=tvecs, codes_all=codes.dev, nseg=nseg)


def window_scores(tables, tvecs, codes_all, p: int, wins,
                  multi_hits: bool = True,
                  hmmer3_compat: bool = False) -> tuple:
    """(alt, null) (n,) of (start, stop) code-row windows scored alone by
    B1 against profile p, on the tables' device."""
    import torch

    from .xtrans import xtrans_cost_vector

    from .ops.viterbi import scores_pairs

    dev = tables.device
    n = len(wins)
    xts = np.zeros((1, n, 16), np.float32)
    for i, (a, b) in enumerate(wins):
        xts[0, i, :13] = xtrans_cost_vector(multi_hits, hmmer3_compat, b - a)
    lens = np.array([[[b - a] for a, b in wins]], np.int32)
    alt, nul = scores_pairs(
        torch.tensor([p], dtype=torch.int32, device=dev), tables, tvecs,
        torch.from_numpy(xts).to(dev), torch.from_numpy(lens).to(dev),
        torch.tensor([[a for a, _ in wins]], dtype=torch.int32, device=dev),
        codes_all)
    return alt[0], nul[0]


def planted_read(rng: np.random.Generator, profile: FrameProfile,
                 length: int, noise: float = 0.0,
                 nodes: tuple[int, int] | None = None) -> str:
    """A `length`-nt read (longer if the domain is) with the profile's
    argmax-codon domain, or the stretch of its nodes [a, b), at a random
    offset."""
    dom = mutate(rng, domain_bases(profile, nodes), noise)
    flank = max(length - len(dom), 0)
    left = int(rng.integers(0, flank + 1))
    return random_bases(rng, left) + dom + random_bases(rng, flank - left)


PFAM_PLANTED = (60, 100, 140, 180)  # profiles whose domains the reads carry


def pfam_scan(n_profiles: int = 200, n_reads: int = 8,
              read_len: int = 10_000, seed: int = 2024):
    """The Pfam-shaped scan of chip_smoke.py: profiles
    sample_profile(200 + i, K_i) with K geometric over 50..2000, and reads
    of `read_len` nt, the first four carrying the planted domain (1%
    indel/substitution noise) of profiles PFAM_PLANTED.  Returns
    (profiles, sequences)."""
    from .profile import sample_profile
    from .scan.sequence import Sequence

    ks = pfam_ks(n_profiles)
    profiles = [sample_profile(200 + i, k) for i, k in enumerate(ks)]
    rng = np.random.default_rng(seed)
    planted = [i for i in PFAM_PLANTED if i < n_profiles][:n_reads]
    reads = [planted_read(rng, profiles[i], read_len, noise=0.01)
             for i in planted]
    reads += [random_bases(rng, read_len)
              for _ in range(n_reads - len(reads))]
    return profiles, [Sequence.make(i, f"read{i}", r)
                      for i, r in enumerate(reads)]


# The STATS LOCAL FORWARD line `sample_hmm` gives every profile: (tau,
# lambda), synthetic (lambda = ln 2, HMMER3's usual for Forward tails).
SAMPLE_FORWARD_STATS = (-4.0, 0.69315)


def sample_hmm(seed: int, core_size: int):
    """The amino profile that `profile.sample_profile(seed, core_size)`
    presses, with the null amino lprobs it presses it against: (HMMProfile,
    null_lprobs (20,) f64).  It replays sample_profile's numpy draws in
    their order, so `press_profile(hmm, 1, 0.1, null_amino_lprobs=null)`
    gives sample_profile's FrameProfile.  The profile carries a synthetic
    STATS LOCAL FORWARD line, SAMPLE_FORWARD_STATS (not a calibration of
    this profile), so that the confirmer can give e-values; it has no
    GA."""
    from .hmmfile import NUM_AMINO, T_DD, T_MD, HMMProfile

    rng = np.random.default_rng(seed)

    def sample_lprobs(n):
        p = rng.random(n)
        return np.log(p / p.sum())

    null_lprobs = sample_lprobs(NUM_AMINO)
    match_lprobs = np.stack([sample_lprobs(NUM_AMINO)
                             for _ in range(core_size)])
    trans = np.empty((core_size + 1, 7), dtype=np.float64)
    for i in range(core_size + 1):
        t = rng.random(7)
        logt = np.log(t)
        if i == 0:
            logt[T_DD] = -np.inf
        if i == core_size:
            logt[T_MD] = -np.inf
            logt[T_DD] = -np.inf
        m = np.max(logt)
        logt = logt - (np.log(np.sum(np.exp(logt - m))) + m)
        trans[i] = logt
    hmm = HMMProfile(
        name=f"sample{seed}", accession=f"SAMPLE{seed}", length=core_size,
        consensus="-" * core_size,
        match_lprobs=match_lprobs.astype(np.float32),
        trans=trans.astype(np.float32),
        stats={"FORWARD": SAMPLE_FORWARD_STATS})
    return hmm, null_lprobs


def peaked_hmm(seed: int, core_size: int):
    """An amino profile shaped like a curated one, whose planted domains
    confirm: each node's match emissions put 0.6 on one residue and spread
    0.4 over the rest at random, transitions M->M 0.9, M->I 0.05, M->D 0.05,
    I->M 0.6, I->I 0.4, D->M 0.7, D->D 0.3 (none out of the last node's D),
    the synthetic SAMPLE_FORWARD_STATS line.  (sample_hmm's profiles give
    M->M about 1/7, so their domains score far below the null model in the
    Forward and never confirm.)"""
    from .hmmfile import NUM_AMINO, T_DD, T_DM, T_II, T_IM, T_MD, T_MI, \
        T_MM, HMMProfile

    rng = np.random.default_rng(seed)
    match = rng.random((core_size, NUM_AMINO))
    match *= 0.4 / match.sum(1, keepdims=True)
    match[np.arange(core_size), rng.integers(0, NUM_AMINO, core_size)] += 0.6
    trans = np.full((core_size + 1, 7), -np.inf)
    for col, p in ((T_MM, 0.9), (T_MI, 0.05), (T_MD, 0.05), (T_IM, 0.6),
                   (T_II, 0.4), (T_DM, 0.7), (T_DD, 0.3)):
        trans[:, col] = np.log(p)
    trans[0, T_DD] = trans[core_size, T_DD] = -np.inf
    trans[0, T_DM] = trans[core_size, T_DM] = 0.0
    trans[core_size, T_MD] = -np.inf
    trans[core_size, T_MM] = np.log(0.95)
    return HMMProfile(
        name=f"peaked{seed}", accession=f"PEAKED{seed}", length=core_size,
        consensus="-" * core_size, match_lprobs=np.log(match).astype(
            np.float32),
        trans=trans.astype(np.float32),
        stats={"FORWARD": SAMPLE_FORWARD_STATS})


CONFIRM_KS = (9, 95, 70, 50, 200)


def confirm_case(ks=CONFIRM_KS, read_len: int = 700, seed: int = 3):
    """A scan whose LRT hits the confirmer both keeps and drops: the
    profiles peaked_hmm(40 + i, ks[i]) pressed as the reference presses
    them (K = 9 takes two windows a read), and reads of `read_len` nt: the
    first two carry the whole domain of profiles 1 and 4 (1% noise), the
    third a 12-node stretch of profile 2, the fourth is random.  Returns
    (hmms, profiles, sequences)."""
    from .profile import press_profile
    from .scan.sequence import Sequence

    hmms = [peaked_hmm(40 + i, k) for i, k in enumerate(ks)]
    profiles = [press_profile(h, 1, 0.1) for h in hmms]
    rng = np.random.default_rng(seed)
    reads = [planted_read(rng, profiles[1], read_len, noise=0.01),
             planted_read(rng, profiles[4], read_len, noise=0.01),
             planted_read(rng, profiles[2], read_len, noise=0.01,
                          nodes=(0, 12)),
             random_bases(rng, read_len)]
    return hmms, profiles, [Sequence.make(i, f"c{i}", r)
                            for i, r in enumerate(reads)]


def exact_confirmer(hmms, **kw):
    """NativeConfirmer(hmms, device="cpu", **kw) whose scorer evaluates
    the plain versions in f64: the kernels' function without the f32
    rounding that log space accumulates over a long hit, the yardstick
    the kernels are held to on long hits."""
    from .hmmer import forward as hf

    plain = {hf.amino_forward: hf.amino_forward_plain,
             hf.amino_posterior: hf.amino_posterior_plain}

    class ExactScorer(hf.AminoForwardScorer):
        def _launch_groups(self, hits, fn, posterior=False):
            def f64(**a):
                return plain[fn](**{k: v.double() if v.is_floating_point()
                                    else v for k, v in a.items()})
            return super()._launch_groups(hits, f64, posterior)

    conf = hf.NativeConfirmer(hmms, device="cpu", **kw)
    conf.scorer = ExactScorer(hmms, device="cpu")
    return conf


def pfam_scan_hmms(n_profiles: int = 200) -> list:
    """The HMMProfiles of `pfam_scan`'s database (sample_hmm(200 + i,
    K_i)), for NativeConfirmer."""
    return [sample_hmm(200 + i, k)[0]
            for i, k in enumerate(pfam_ks(n_profiles))]


def _hmm_scores(row) -> str:
    """HMMER3 score columns: negated natural logs, '*' for -inf."""
    neg = (0.0 - np.asarray(row, np.float64)).tolist()
    return " ".join(map("{:.5f}".format, neg)).replace("inf", "*")


def hmm_text(hmms) -> str:
    """The HMMER3/f text of amino HMMProfiles (what `hmmfile.read_hmm`
    parses back, within the 5 decimals of the score columns): name,
    accession, description, GA and STATS LOCAL lines where the profile has
    them; node 0's COMPO line where it has one; insert emissions from
    `insert_lprobs`, else the null amino lprobs; node k's consensus
    residue in its CONS column."""
    from .hmmfile import NUM_AMINO
    from .profile import NULL_AMINO_LPROBS

    head = ("HMM     " + "".join(f"{a:>9}" for a in "ACDEFGHIKLMNPQRSTVWY")
            + "\n            m->m     m->i     m->d     i->m     i->i     "
            "d->m     d->d\n")
    out = []
    for h in hmms:
        K = h.length
        ins = (h.insert_lprobs if h.insert_lprobs is not None
               else np.tile(NULL_AMINO_LPROBS[:NUM_AMINO], (K + 1, 1)))
        lines = ["HMMER3/f [3.3 | Nov 2019]", f"NAME  {h.name}"]
        if h.accession:
            lines.append(f"ACC   {h.accession}")
        if h.description:
            lines.append(f"DESC  {h.description}")
        lines += [f"LENG  {K}", f"ALPH  {h.alphabet}"]
        if h.ga is not None:
            lines.append(f"GA    {h.ga[0]:.2f} {h.ga[1]:.2f};")
        lines += [f"STATS LOCAL {k:<8} {a:9.5f} {b:9.5f}"
                  for k, (a, b) in h.stats.items()]
        lines.append(head.rstrip("\n"))
        if h.compo is not None:
            lines.append("  COMPO   " + _hmm_scores(h.compo))
        lines.append("          " + _hmm_scores(ins[0]))
        lines.append("          " + _hmm_scores(h.trans[0]))
        cons = h.consensus or "-" * K
        for k in range(1, K + 1):
            lines.append(f"{k:>7}   " + _hmm_scores(h.match_lprobs[k - 1])
                         + f" {k:>6} {cons[k - 1]} - - -")
            lines.append("          " + _hmm_scores(ins[k]))
            lines.append("          " + _hmm_scores(h.trans[k]))
        lines.append("//")
        out.append("\n".join(lines) + "\n")
    return "".join(out)


def amino_hits(Kpad: int, lengths, seed: int, device="cpu",
               degenerate: float = 0.05) -> dict:
    """A batch of hits of one Kpad for the amino Forward and posterior
    kernels: hit h an amino string of lengths[h] residues (a share
    `degenerate` of them 'X') against sample_hmm(seed + h, K_h), K_h drawn
    from (Kpad / 2, Kpad] (at least 2).  Returns the kernels' arguments
    (em, tv, res, off, xv) with the strings `seqs` and the sizes `ks`."""
    from .alphabet import AMINO
    from .hmmer.forward import AminoForwardScorer

    rng = np.random.default_rng(seed)
    ks = [max(2, int(rng.integers(Kpad // 2 + 1, Kpad + 1)))
          for _ in lengths]
    scorer = AminoForwardScorer([sample_hmm(seed + h, k)[0]
                                 for h, k in enumerate(ks)], device=device)
    seqs = ["".join("X" if rng.random() < degenerate
                    else AMINO[int(rng.integers(0, 20))] for _ in range(n))
            for n in lengths]
    args, _ = scorer._staged(list(enumerate(seqs)))
    assert args["em"].shape[2] == Kpad, (Kpad, ks)
    return dict(args, seqs=seqs, ks=ks)


# Domains of the long-read scan.  Profile 140 (K = 670) sat on read 0
# before, but its planted domain scores below the null (LRT < 0 on whole
# reads of 22 to 40 knt), so read 0 carries profile 150's.
LONGREAD_PLANTED = (150, 180, 60)


def pfam_longread(profiles=None, n_reads: int = 3, read_len: int = 24_000,
                  seed: int = 2025):
    """The long-read scan of chip_smoke.py: `pfam_scan`'s 200-profile
    database (or `profiles`, that database already built) and `n_reads`
    reads of `read_len` nt (past the chain cap's 20,480 nt, and short
    enough that the plain versions of chip_smoke.py's own-shape checks
    keep it within its time).  Reads 0 and 1 carry the planted domains of
    profiles 150 and 180 (K = 806 and 1406, whose windows are the whole
    read up to 40.3 and 70.3 knt: past 20,480 nt they are over the chain
    cap of the unpacked tiers), read 2 that of profile 60 (K = 152, a
    chain window), the rest are random; 1% indel/substitution noise.
    Returns (profiles, sequences)."""
    from .scan.sequence import Sequence

    if profiles is None:
        profiles, _ = pfam_scan(n_reads=0)
    rng = np.random.default_rng(seed)
    planted = list(LONGREAD_PLANTED[:n_reads])
    reads = [planted_read(rng, profiles[i], read_len, noise=0.01)
             for i in planted]
    reads += [random_bases(rng, read_len)
              for _ in range(n_reads - len(reads))]
    return profiles, [Sequence.make(i, f"long{i}", r)
                      for i, r in enumerate(reads)]


def pfam_subset(profiles=None, seed: int = 7, read_len: int = 1200):
    """The card-against-CPU subset of a `pfam_scan` database: every tenth
    profile with K <= 400, at most 12 (planted profile 100 among them),
    and two reads of `read_len` nt, the first carrying profile 100's
    domain (1% noise).  Without `profiles`, the subset of `pfam_scan()`'s
    database, drawing only the subset's profiles.  Returns (profiles,
    sequences)."""
    from .profile import sample_profile
    from .scan.sequence import Sequence

    ks = ([p.core_size for p in profiles] if profiles is not None
          else pfam_ks(200))
    sub = [i for i, k in enumerate(ks) if k <= 400][::10][:12]
    assert 100 in sub, "the subset lost its planted profile"
    if profiles is None:  # pfam_scan()'s draws, for the subset alone
        profiles = {i: sample_profile(200 + i, ks[i]) for i in sub}
    rng = np.random.default_rng(seed)
    reads = [planted_read(rng, profiles[100], read_len, noise=0.01),
             random_bases(rng, read_len)]
    return ([profiles[i] for i in sub],
            [Sequence.make(i, n, r) for i, (n, r) in
             enumerate(zip(("p0", "r1"), reads))])


# The large-K scan's profiles: sample_profile(seed, K).  Seed 605 would
# draw a K = 16384 profile whose argmax-codon stretches all score below the
# null (LRT < 0 on every planted read tried), so it takes seed 606.
LARGEK_KS = (5200, 5300, 8192, 8200, 16383, 16384)
LARGEK_SEEDS = (600, 601, 602, 603, 604, 606)
# read i carries the argmax-codon stretch of (profile, nodes [a, b))
LARGEK_PLANTED = ((0, (0, 5200)), (5, (4000, 10000)), (2, (1000, 5000)))


def pfam_largek():
    """The large-K scan of chip_smoke.py: six profiles
    sample_profile(LARGEK_SEEDS[i], K) over the reference's whole large-K
    range, K = 5200, 5300 (bucket Kp 5632), 8192, 8200 (8704) and 16383,
    16384 (16896, the bucket of the reference's largest profile,
    K = 16384), at full width; and six reads of 20 knt, 1%
    indel/substitution noise on the planted stretches: read 0 carries K = 5200's whole domain
    (15.6 knt), read 1 nodes 4000-10000 of K = 16384 (18 knt), read 2 nodes
    1000-5000 of K = 8192 (12 knt), the rest are random.  Every window of
    such a profile is a whole read (min(50 K, 100 knt)).  Such scans are
    run by users whose databases hold giant multi-domain profiles (titins,
    polyketide synthases, large viral polyproteins) up to the reference's
    K limit.  Returns (profiles, sequences)."""
    from .profile import sample_profile
    from .scan.sequence import Sequence

    profiles = [sample_profile(s, k) for s, k in zip(LARGEK_SEEDS, LARGEK_KS)]
    rng = np.random.default_rng(2026)
    reads = [planted_read(rng, profiles[p], 20_000, noise=0.01, nodes=nodes)
             for p, nodes in LARGEK_PLANTED]
    reads += [random_bases(rng, 20_000) for _ in range(3)]
    return profiles, [Sequence.make(i, f"big{i}", r)
                      for i, r in enumerate(reads)]


def largek_subset(profiles):
    """The card-against-CPU subset of the large-K scan: the first two
    profiles of `pfam_largek`'s (K = 5200 and 5300) and two reads of 2 knt,
    the first carrying nodes 2000-2500 of K = 5200 (1% noise).  Returns
    (profiles, sequences)."""
    from .scan.sequence import Sequence

    profiles = list(profiles[:2])
    rng = np.random.default_rng(8)
    reads = [planted_read(rng, profiles[0], 2000, noise=0.01,
                          nodes=(2000, 2500)),
             random_bases(rng, 2000)]
    return profiles, [Sequence.make(i, n, r) for i, (n, r) in
                      enumerate(zip(("k0", "k1"), reads))]


# The mid-K scan's profiles: two in each plain bucket past Kp 2048
# (scan/scheduler.py's rule: round_up(K + 2, 128), then past 2048 up to a
# multiple of 512): K 2100, 2400 -> 2560; 2600, 3000 -> 3072; 3300, 3500
# -> 3584; 3700, 4000 -> 4096; 4200, 4500 -> 4608; 4608, 5100 -> 5120.
MIDK_KS = (2100, 2400, 2600, 3000, 3300, 3500, 3700, 4000, 4200, 4500, 4608,
           5100)
# Profile i is sample_profile(MIDK_SEEDS[i], MIDK_KS[i]).  Seeds 706 and 710
# would draw K 3700 and 4608 profiles whose planted domains score below the
# null (LRT < 0 on every 24-knt read tried), so those take 717 and 715.
MIDK_SEEDS = (700, 701, 702, 703, 704, 705, 717, 707, 708, 709, 715, 711)
# read i carries the argmax-codon stretch of (profile, nodes [a, b)):
# K 2100 whole (6.3 knt) in a 10-knt read, K 3700 nodes 0-3700 and K 4608
# nodes 0-4608 (11.1 and 13.8 knt) in the two 24-knt reads
MIDK_PLANTED = ((0, (0, 2100)), (6, (0, 3700)), (10, (0, 4608)))
MIDK_READS = (10_000, 24_000, 24_000, 10_000, 10_000, 10_000)


def pfam_midk():
    """The mid-K scan of chip_smoke.py: twelve profiles
    sample_profile(MIDK_SEEDS[i], K) at MIDK_KS, two in each plain bucket
    past Kp 2048 (2560 to 5120, the band where B1, B3, B5 and B8 run on
    thread-block clusters), at full width; six reads (MIDK_READS): four of
    10 knt, whose whole-read windows chain, and two of 24 knt, whose
    windows pass the chain cap's 512 blocks and ride the gang (carry
    segments under DECIPHON_CHAIN_SEG=1); reads 0-2 carry MIDK_PLANTED's
    stretches with 1% indel/substitution noise, so that survivors run B2 on
    clusters and the walk.  Every window of such a profile is a whole read
    (min(50 K, 100 knt)).  Users of databases with profiles of 2047-5118
    nodes (long Pfam and NCBIfam families, bench.py's BIG_K 4608) scan
    like this.  Returns (profiles, sequences)."""
    from .profile import sample_profile
    from .scan.sequence import Sequence

    profiles = [sample_profile(s, k) for s, k in zip(MIDK_SEEDS, MIDK_KS)]
    rng = np.random.default_rng(2027)
    reads = [planted_read(rng, profiles[p], n, noise=0.01, nodes=nodes)
             for (p, nodes), n in zip(MIDK_PLANTED, MIDK_READS)]
    reads += [random_bases(rng, n) for n in MIDK_READS[len(reads):]]
    return profiles, [Sequence.make(i, f"mid{i}", r)
                      for i, r in enumerate(reads)]


def midk_subset(profiles):
    """The card-against-CPU subset of the mid-K scan: its profiles of K 2100
    and 4608 (`pfam_midk`'s 0 and 10, buckets 2560 and 5120) and two reads
    of 1.2 knt carrying nodes 800-1200 of K 2100 and 2000-2400 of K 4608
    (1% noise).  Returns (profiles, sequences)."""
    from .scan.sequence import Sequence

    sub = [profiles[0], profiles[10]]
    rng = np.random.default_rng(9)
    reads = [planted_read(rng, sub[0], 1200, noise=0.01, nodes=(800, 1200)),
             planted_read(rng, sub[1], 1200, noise=0.01, nodes=(2000, 2400))]
    return sub, [Sequence.make(i, n, r) for i, (n, r) in
                 enumerate(zip(("m0", "m1"), reads))]


# xnode and node fields of the trellis words: (offset, width)
_XN_FIELD = {"N": (0, 4), "B": (4, 2), "E": (6, 15), "C": (21, 4),
             "T": (25, 1), "J": (26, 4)}
_ND_FIELD = {"M": (0, 5), "D": (5, 1), "I": (6, 4)}


def _plant(xn: np.ndarray, nd: np.ndarray, path: list, taken: dict) -> int:
    """Write the trellis fields that make the walk from T follow `path`
    (forward (state, size) steps, S first, T last) back to S; returns its
    length.  The walk at state X and stage s reads row s-1 (the zero row
    at stage 0): X's field there names the state before X and X's size."""
    from . import states as st

    names = {st.STATE_S: "S", st.STATE_N: "N", st.STATE_B: "B",
             st.STATE_E: "E", st.STATE_J: "J", st.STATE_C: "C",
             st.STATE_T: "T"}
    stage = 0
    for (p, _), (x, size) in zip(path, path[1:]):
        stage += size
        if st.is_core(x):
            k = st.core_idx(x)
            if st.is_match(x):
                field = "M"
                choice = 0 if p == st.STATE_B else {
                    st.STATE_M: 1, st.STATE_I: 2,
                    st.STATE_D: 3}[st.state_class(p)]
                assert choice == 0 or st.core_idx(p) == k - 1, (p, x)
                v = choice * 5 + size - 1
            elif st.is_delete(x):
                field = "D"
                assert size == 0 and st.core_idx(p) == k - 1, (p, x)
                assert not st.is_insert(p), (p, x)
                v = int(st.is_delete(p))
            else:
                field = "I"
                assert st.core_idx(p) == k and not st.is_delete(p), (p, x)
                v = int(st.is_insert(p)) * 5 + size - 1
            off, width = _ND_FIELD[field]
        else:
            field, k = names[x], 0
            if field == "B":
                v = {"S": 0, "N": 1, "E": 2, "J": 3}[names[p]]
            elif field == "E":
                v = 2 * st.core_idx(p) + int(st.is_delete(p))
            elif field == "T":
                v = int(names[p] == "C")
            else:  # N, C, J: the state before is the field's first or itself
                v = int(p == x) * 5 + size - 1
            off, width = _XN_FIELD[field]
        assert 0 <= v < (1 << width) and 0 <= size <= 5, (x, v, size)
        if stage == 0:  # the zero row: only B <- S reads it
            assert v == 0 and field == "B", (x, v)
            continue
        key = (stage - 1, field, k)
        assert taken.setdefault(key, v) == v, key
        plane = nd[stage - 1] if st.is_core(x) else xn
        col = k if st.is_core(x) else stage - 1
        mask = ((1 << width) - 1) << off
        plane[col] = (int(plane[col]) & ~mask) | (v << off)
    return stage


def walk_cases(Kp: int = 256, Lk: int = 1024, seed: int = 0,
               device="cpu") -> dict:
    """Trellises planted with the traceback walk's edge cases, one row each
    of xn (R, Lk) and nd (R, Lk, Kp) int32, every word off the paths
    random (as rows past a window's length are): E jumping to k = 0 and
    to k = Kp - 1; a D chain over every column but two, in one row; an I
    run in one column over Lk / 3 rows; stretches of N, J and C only; a
    domain starting at stage 1; a diagonal domain over most columns, with
    I runs, deletes and codons of 2 and 4 nt; an overflow at `max_steps`
    (Lk + 4 Kp + 64, the scan's first try: rounds of a D chain over every
    column), an underflow (C claiming 5 nt at stage 2) and a length-0 walk.
    Returns dict(xn, nd, rows, lengths, max_steps) as `walk` takes them,
    with `names` and `paths` (each case's forward (state, size) steps, None
    where no walk reaches S)."""
    import torch

    from . import states as st

    assert Kp >= 8 and Lk >= 64, (Kp, Lk)
    S, N, B, E, J, C, T = (st.STATE_S, st.STATE_N, st.STATE_B, st.STATE_E,
                           st.STATE_J, st.STATE_C, st.STATE_T)
    M, I, D = st.make_match_id, st.make_insert_id, st.make_delete_id
    max_steps = Lk + 4 * Kp + 64

    def run(state, n, sizes=(3,)):
        return [(state, sizes[i % len(sizes)]) for i in range(n)]

    def fill(path, n_left):
        """C steps of 3 nt (or fewer) up to n_left nt, then T."""
        return path + run(C, n_left // 3) + [(T, 0)]

    q = Lk // 12
    cols = min(Kp - 10, (Lk - 120) * 10 // 36)  # the diagonal domain
    dom = [(B, 0)]
    for i, k in enumerate(range(8, 8 + cols)):
        if i % 23 == 22 and st.is_match(dom[-1][0]):
            dom.append((D(k), 0))  # D follows M or D only
            continue
        dom.append((M(k), (2, 3, 3, 4, 3)[i % 5]))
        if i % 17 == 5:
            dom += run(I(k), 2)
    rounds = max_steps // (Kp + 3) + 2
    loop = [(S, 0), (N, 3)]
    for r in range(rounds):
        loop += [(B, 0), (M(0), 3), *[(D(k), 0) for k in range(1, Kp - 1)],
                 (M(Kp - 1), 3), (E, 0)]
        loop += [(J, 3)] if r < rounds - 1 else [(C, 3), (T, 0)]
    cases = {
        "e_to_k0": fill([(S, 0), *run(N, 4), (B, 0), (M(0), 3), (E, 0)], 30),
        "e_to_last": fill([(S, 0), (N, 2), (B, 0),
                           *[(M(k), 3) for k in range(Kp - 6, Kp)], (E, 0)],
                          20),
        "d_chain": fill([(S, 0), (N, 3), (B, 0), (M(1), 3),
                         *[(D(k), 0) for k in range(2, Kp)], (E, 0)], 9),
        "i_run": fill([(S, 0), *run(N, 2), (B, 0), (M(3), 3),
                       *run(I(3), Lk // 9, (3, 2, 4)), (M(4), 3), (M(5), 1),
                       (E, 0)], 12),
        "specials": [(S, 0), *run(N, q, (1, 2, 3, 4, 5)), (B, 0),
                     (M(Kp // 2), 3), (E, 0), *run(J, q, (5, 4, 3, 2, 1)),
                     (B, 0), (M(Kp // 3), 3), (E, 0), *run(C, q, (2, 4, 3)),
                     (T, 0)],
        "stage1": fill([(S, 0), (B, 0), (M(7), 1), (M(8), 3), (M(9), 3),
                        (E, 0)], 6),
        "long_domain": fill([(S, 0), *run(N, 10), *dom, (E, 0)], 30),
        "overflow": loop,
        "underflow": None,
        "empty": None,
    }
    rng = np.random.default_rng(seed)
    R = len(cases) + 1  # and a row no walk reads
    xn = rng.integers(0, 1 << 30, size=(R, Lk), dtype=np.int64)
    nd = rng.integers(0, 1 << 30, size=(R, Lk, Kp), dtype=np.int64)
    lengths, paths = [], []
    for r, (name, path) in enumerate(cases.items()):
        if name == "underflow":
            # T <- C at stage 2; C claims 5 nt there (its own previous)
            xn[r, 1] = (1 << 25) | ((5 + 4) << 21)
            lengths.append(2)
        elif name == "empty":
            lengths.append(0)
        else:
            lengths.append(_plant(xn[r], nd[r], path, {}))
            assert lengths[-1] <= Lk, (name, lengths[-1], Lk)
            assert (len(path) - 1 > max_steps) == (name == "overflow"), name
        paths.append(path)
    order = rng.permutation(len(cases))
    return dict(
        xn=torch.from_numpy(xn.astype(np.int32)).to(device),
        nd=torch.from_numpy(nd.astype(np.int32)).to(device),
        rows=torch.tensor(order, dtype=torch.int32, device=device),
        lengths=torch.tensor([lengths[i] for i in order], dtype=torch.int32,
                             device=device),
        max_steps=max_steps,
        names=[list(cases)[i] for i in order],
        paths=[paths[i] for i in order])


def assemble_walk_cases(c: dict, got) -> dict:
    """The walks of `walk_cases` `c` that end, as the scan pipeline
    assembles them from the walk's output `got` (sts, szs, ns, oks on the
    trellis's device): {case index: (sids, sizes)}, the overflow walked
    again by `rewalk` on that device (counted in REWALKS)."""
    from .ops import traceback as tb

    keep = [b for b, n in enumerate(c["names"])
            if n not in ("underflow", "empty")]
    items = [object() for _ in keep]
    out: dict = {}
    tb.assemble_path_entries(
        [(items, *(a[keep] for a in got), c["xn"], c["nd"],
          [int(c["rows"][b]) for b in keep],
          [int(c["lengths"][b]) for b in keep])],
        [a.cpu().numpy()[keep] for a in got], out)
    return {b: out[id(it)] for b, it in zip(keep, items)}

