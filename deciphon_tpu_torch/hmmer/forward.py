"""Native amino-Forward scoring + e-values on PyTorch: the daemon-free
confirmer.

Counterpart of deciphon_tpu/hmmer/forward.py: the HMMER3 local multihit
Forward algorithm on the amino profile, with e-values from the profile's
own STATS LOCAL FORWARD calibration line (exponential tail:
P = exp(-lambda * (S - tau)), E = Z * P), and the HMMER3-style null2
biased-composition correction from a full posterior decoding (Forward +
Backward).  The model, the score convention and the keep policy are the
reference's (see its docstring); the host parts here are kept op for op.

Device functions, each a kernel with its plain PyTorch version beside it:

  * `amino_forward`  <- `_jit_forward` (`dtt_amino_forward` in
    csrc/amino_forward.cu): the Forward score in nats;
  * `amino_posterior`  <- `_jit_posterior` (`dtt_amino_posterior`): the
    Forward, the Backward and the posterior usages gM, gI and gNCJ.

Both take a batch of hits of one Kpad: `em` (H, 21, Kpad) f32, each hit's
profile odds table with a row per residue (20 aminos, then the degenerate
residues: 0 at the K real nodes, _NEG past them, as the reference patches
its emission rows); `tv` (H, NUM_TV, Kpad) f32, the reference's nine
transition vectors and the two sums of tdd the D chains use (`dd_sums`);
`res` (N,) int32, the residue rows of every hit, hit h at [off[h],
off[h + 1]); `off` (H + 1,) int32; `xv` (H, 10) f32, the special-state
scores in the X_* order.  Neither builds the reference's (Lpad, Kpad)
emission plane: a position reads its residue's row of the resident table,
and the loops run over the true L (the reference's padded steps only
carry the state through).  CPU tensors run the plain version, CUDA
tensors the kernel (built from csrc/ on first use) or raise; the kernel
launches count in ops/viterbi.py LAUNCHES ("amino_forward",
"amino_posterior").  The kernels run in scaled odds space (see
csrc/amino_forward.cu); the plain versions follow the reference op for op
in log space, and the two agree within the reference's tolerance.

`NativeConfirmer.confirm_many` confirms a wave's hits at once: the hits
are grouped by Kpad (`kpad_groups`) and each group is one launch.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..alphabet import AMINO_INDEX
from ..hmmfile import (HMMProfile, NUM_AMINO, T_DD, T_DM, T_II, T_IM, T_MD,
                       T_MI, T_MM)
from ..logging import to_host
from ..ops import viterbi as vk
from ..profile import NULL_AMINO_LPROBS
from ..xtrans import xtrans_setup

LN2 = math.log(2.0)
_NEG = -1e30  # -inf stand-in that survives arithmetic

# rows of `tv`: the reference's vectors in its argument order, then
# S = cumsum(tdd) and Srev, the Backward's suffix sums (`dd_sums`)
(TV_MM, TV_IM, TV_DM, TV_MI, TV_II, TV_MD, TV_DD, TV_BM, TV_DV, TV_S,
 TV_SREV) = range(11)
NUM_TV = 11
# the special-state scores of `xv`, in the reference's argument order
(X_NN, X_NB, X_EJC, X_JJ, X_JB, X_EB, X_ECC, X_CC, X_ET, X_CT) = range(10)
MAX_KPAD = 16384  # the bucket of the reference's largest profile


def _pad_pow2(n: int, minimum: int = 16) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# plain versions: the reference's step functions, op for op
# ---------------------------------------------------------------------------


def _lse(*xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = torch.logaddexp(acc, x)
    return acc


def _shift(x):  # out[k] = x[k-1]
    return torch.cat([x.new_full((1,), _NEG), x[:-1]])


def _shift_back(x):  # out[k] = x[k+1]
    return torch.cat([x[1:], x.new_full((1,), _NEG)])


def dd_sums(tdd: torch.Tensor):
    """(S, Srev) of a profile's tdd (Kpad,): S = cumsum(tdd), the
    Forward's D-chain sums; Srev the Backward's suffix sums of tdd[k + 1],
    its pad sentinels (< -1e20) zeroed (folding them into real lanes would
    annihilate the mantissa)."""
    c = _shift_back(tdd)
    c = torch.where(c < -1e20, torch.zeros_like(c), c)
    return torch.cumsum(tdd, 0), torch.cumsum(c.flip(0), 0).flip(0)


def _forward_rows(em, tv, seq, x, keep: bool):
    """One hit's Forward (the reference's `step`): fwd nats, and with
    `keep` the kept M and I rows and N, J, C of every position."""
    tmm, tim, tdm, tmi, tii, tmd, tdd, tbm = tv[:TV_DV]
    S, _ = dd_sums(tdd)
    M = torch.full_like(tmm, _NEG)
    I, D = M.clone(), M.clone()
    N = x[X_NN].new_zeros(())  # S->N = 1
    B = N + x[X_NB]
    E = J = C = x.new_full((), _NEG)
    rows = []
    for r in seq:
        Mrow = em[r] + _lse(_shift(_lse(M + tmm, I + tim, D + tdm)),
                            B + tbm)
        Irow = _lse(M + tmi, I + tii)  # insert odds emission = 0
        A = _shift(Mrow) + tmd
        G = A - S
        P = torch.logcumsumexp(G, 0)
        Drow = P + S
        Erow = _lse(torch.logsumexp(Mrow, 0), torch.logsumexp(Drow, 0))
        Nrow = N + x[X_NN]
        Jrow = _lse(E + x[X_EJC], J + x[X_JJ])
        Crow = _lse(E + x[X_ECC], C + x[X_CC])
        Brow = _lse(Nrow + x[X_NB], Erow + x[X_EB], Jrow + x[X_JB])
        M, I, D, N, B, E, J, C = Mrow, Irow, Drow, Nrow, Brow, Erow, Jrow, Crow
        if keep:
            rows.append((M, I, torch.stack([N, J, C])))
    return torch.logaddexp(E + x[X_ET], C + x[X_CT]), rows


def _hits(off):
    o = off.tolist()
    return list(zip(o[:-1], o[1:]))


def amino_forward_plain(em, tv, res, off, xv):
    """Plain PyTorch `_jit_forward` over a batch of hits: (H,) f32 nats."""
    res = res.tolist()
    return torch.stack([
        _forward_rows(em[h], tv[h], res[a:b], xv[h], keep=False)[0]
        for h, (a, b) in enumerate(_hits(off))])


def _posterior_one(em, tv, seq, x):
    """One hit's `_jit_posterior`: (3 + Kpad,) = fwd, gI, gNCJ, gM."""
    fwd, rows = _forward_rows(em, tv, seq, x, keep=True)
    tmm, tim, tdm, tmi, tii, tmd, tdd, tbm, dvalid = tv[:TV_S]
    Kpad = tmm.shape[0]
    L = len(seq)
    if L == 0:
        zero = fwd.new_zeros(())
        return torch.cat([torch.stack([fwd, zero, zero]),
                          fwd.new_zeros(Kpad)])
    # ---- backward: b-values are suffix scores AFTER emitting position l;
    # l = L..1, `end` firing at l == L (T reachable only there) ----
    _, Srev = dd_sums(tdd)
    neg = torch.full_like(tmm, _NEG)
    bM_n, bI_n = neg, neg
    bN_n = bJ_n = bC_n = x.new_full((), _NEG)
    out = [None] * L
    for l in range(L, 0, -1):
        em_n = em[seq[l]] if l < L else neg  # emission row of position l+1
        end = x.new_zeros(()) if l == L else x.new_full((), _NEG)
        mb = em_n + bM_n
        bB = torch.logsumexp(tbm + mb, 0)
        bJ = _lse(x[X_JB] + bB, x[X_JJ] + bJ_n)
        bC = _lse(end + x[X_CT], x[X_CC] + bC_n)
        bE = _lse(end + x[X_ET], x[X_EB] + bB, x[X_EJC] + bJ_n,
                  x[X_ECC] + bC_n)
        R = _lse(bE.expand(Kpad), tdm + _shift_back(mb))
        R = torch.where(dvalid > 0, R, neg)
        Prev = torch.logcumsumexp((R - Srev).flip(0), 0).flip(0)
        bD = Prev + Srev
        bM = _lse(bE.expand(Kpad), tmm + _shift_back(mb), tmi + bI_n,
                  _shift_back(tmd + bD))
        bI = _lse(tim + _shift_back(mb), tii + bI_n)
        bN = _lse(x[X_NB] + bB, x[X_NN] + bN_n)
        bM_n, bI_n, bN_n, bJ_n, bC_n = bM, bI, bN, bJ, bC
        out[l - 1] = (bM, bI, torch.stack([bN, bJ, bC]))
    # ---- posterior usages ----
    Mf, If, Xf = (torch.stack(t) for t in zip(*rows))
    bM, bI, bX = (torch.stack(t) for t in zip(*out))
    gM = torch.exp(Mf + bM - fwd).sum(0)
    gI = torch.exp(If + bI - fwd).sum()
    gN, gJ, gC = torch.exp(Xf + bX - fwd).sum(0)
    return torch.cat([torch.stack([fwd, gI, gN + gJ + gC]), gM])


def amino_posterior_plain(em, tv, res, off, xv):
    """Plain PyTorch `_jit_posterior` over a batch of hits:
    (H, 3 + Kpad) f32, each row (fwd, gI, gNCJ, gM...)."""
    res = res.tolist()
    return torch.stack([
        _posterior_one(em[h], tv[h], res[a:b], xv[h])
        for h, (a, b) in enumerate(_hits(off))])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_hits(em, tv, res, off, xv) -> tuple[int, int]:
    H, _, Kpad = em.shape
    vk._check(em, "em", torch.float32, (H, NUM_AMINO + 1, Kpad))
    vk._check(tv, "tv", torch.float32, (H, NUM_TV, Kpad))
    vk._check(res, "res", torch.int32, (res.shape[0],))
    vk._check(off, "off", torch.int32, (H + 1,))
    vk._check(xv, "xv", torch.float32, (H, 10))
    if Kpad < 16 or Kpad > MAX_KPAD or Kpad & (Kpad - 1):
        raise NotImplementedError(
            f"Kpad={Kpad}: the amino kernels take powers of two from 16 to "
            f"{MAX_KPAD}")
    return H, Kpad


# the kernels stage the odds of the transition vectors in shared memory up
# to this Kpad, and past it in a scratch of (H, ODDS_ROWS, Kpad) f32
ODDS_SMEM_MAX_KPAD = 4096
ODDS_ROWS = 9


def _odds_scratch(H: int, Kpad: int, device):
    if Kpad <= ODDS_SMEM_MAX_KPAD:
        return 0  # a null pointer: the kernel stages in shared memory
    return torch.empty((H, ODDS_ROWS, Kpad), dtype=torch.float32,
                       device=device)


def _launch(fn: str, key: str, *args) -> None:
    from .. import _build

    dev = args[0].device
    with torch.cuda.device(dev):
        err = getattr(_build.lib(), fn)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, fn)
    vk.LAUNCHES[key] += 1


def amino_forward(em, tv, res, off, xv):
    """Forward nats (H,) f32 of a batch of hits (module docstring)."""
    H, Kpad = _check_hits(em, tv, res, off, xv)
    if not vk.on_cuda(em, tv, res, off, xv):
        return amino_forward_plain(em, tv, res, off, xv)
    out = torch.empty((H,), dtype=torch.float32, device=em.device)
    _launch("dtt_amino_forward", "amino_forward", em, tv, res, off, xv,
            _odds_scratch(H, Kpad, em.device), out, H, Kpad)
    return out


def amino_posterior(em, tv, res, off, xv):
    """(H, 3 + Kpad) f32, each row (fwd, gI, gNCJ, gM...): the Forward
    nats and the posterior usages of a batch of hits.  On the card the
    Forward's M and I rows, and its specials and scales, go to a scratch
    of (8 Kpad + 16) N bytes."""
    H, Kpad = _check_hits(em, tv, res, off, xv)
    if not vk.on_cuda(em, tv, res, off, xv):
        return amino_posterior_plain(em, tv, res, off, xv)
    n = res.shape[0]
    out = torch.empty((H, 3 + Kpad), dtype=torch.float32, device=em.device)
    Mf = torch.empty((n, Kpad), dtype=torch.float32, device=em.device)
    If = torch.empty_like(Mf)
    Xf = torch.empty((n, 4), dtype=torch.float32, device=em.device)
    _launch("dtt_amino_posterior", "amino_posterior", em, tv, res, off, xv,
            _odds_scratch(H, Kpad, em.device), out, Mf, If, Xf, H, Kpad)
    return out


def kpad_groups(kpads) -> list[tuple[int, list[int]]]:
    """[(Kpad, indices)] of a list of Kpads: one group a distinct Kpad in
    the order of its first hit, each group's indices ascending."""
    groups: dict[int, list[int]] = {}
    for i, k in enumerate(kpads):
        groups.setdefault(k, []).append(i)
    return list(groups.items())


# a posterior launch's Forward scratch, (8 Kpad + 16) bytes a position of
# its hits, stays within this; a Kpad group past it takes more launches
POSTERIOR_SCRATCH_BYTES = 1 << 31


def posterior_scratch_bytes(n: int, Kpad: int) -> int:
    """Bytes of amino_posterior's scratch for n positions at Kpad."""
    return (8 * Kpad + 16) * n


def budget_chunks(ids, lens, Kpad: int, budget: int) -> list[list[int]]:
    """`ids` cut, in order, into the fewest runs whose posterior scratch
    (their `lens` summed) stays within `budget`: one run when it fits, and
    a hit past the budget alone."""
    runs: list[list[int]] = []
    n = 0
    for i, ln in zip(ids, lens):
        if runs and posterior_scratch_bytes(n + ln, Kpad) <= budget:
            runs[-1].append(i)
            n += ln
        else:
            runs.append([i])
            n = ln
    return runs


# ---------------------------------------------------------------------------
# host side: the reference's, op for op
# ---------------------------------------------------------------------------


class AminoForwardScorer:
    """Forward bit scores for amino sequences vs HMMER3 profiles, on
    `device` ("cuda": the kernels; "cpu": their plain versions)."""

    def __init__(self, hmms: list[HMMProfile],
                 null_lprobs: np.ndarray = NULL_AMINO_LPROBS,
                 device="cuda"):
        self.hmms = hmms
        self.null_lprobs = np.asarray(null_lprobs, dtype=np.float64)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"AminoForwardScorer(device={device!r}) but "
                               "no CUDA device is available")
        self._tables: dict = {}

    @functools.lru_cache(maxsize=None)
    def _profile_arrays(self, p_idx: int, Kpad: int):
        hmm = self.hmms[p_idx]
        K = hmm.length
        em = np.full((Kpad, NUM_AMINO + 1), _NEG, np.float32)
        em[:K, :NUM_AMINO] = (hmm.match_lprobs.astype(np.float64)
                              - self.null_lprobs[None, :])
        t = hmm.trans.astype(np.float64)

        def vec(col, src_shift):
            """Transition vector indexed by SOURCE node k (0-based col k =
            node k+1's incoming edge from node k)."""
            v = np.full((Kpad,), _NEG, np.float32)
            v[: K - 1] = t[1:K, col]
            return v

        tmm, tim, tdm = vec(T_MM, 1), vec(T_IM, 1), vec(T_DM, 1)
        # dest-indexed for I (same node) and D entry
        tmi = np.full((Kpad,), _NEG, np.float32)
        tmi[:K] = t[1 : K + 1, T_MI]
        tii = np.full((Kpad,), _NEG, np.float32)
        tii[:K] = t[1 : K + 1, T_II]
        tmd = np.full((Kpad,), _NEG, np.float32)
        tmd[1:K] = t[1:K, T_MD]
        tdd = np.zeros((Kpad,), np.float32)
        tdd[1:K] = np.maximum(t[1:K, T_DD], _NEG / Kpad)
        tdd[K:] = _NEG / Kpad
        # uniform-fragment local entry
        ks = np.arange(Kpad)
        tbm = np.where(
            ks < K,
            np.log(2.0 * np.maximum(K - ks, 1) / (K * (K + 1.0))),
            _NEG).astype(np.float32)
        # lanes holding a real D state (k = 1..K-1), for the backward pass
        dvalid = ((ks >= 1) & (ks < K)).astype(np.float32)
        return em, tmm, tim, tdm, tmi, tii, tmd, tdd, tbm, dvalid

    def _device_arrays(self, p_idx: int, Kpad: int):
        """(em (21, Kpad), tv (NUM_TV, Kpad)) of a profile on the device,
        built once: the odds table a row per residue, its degenerate row 0
        at the K real nodes and _NEG past them (the values the reference
        writes into its emission rows for X and the like)."""
        key = (p_idx, Kpad)
        if key not in self._tables:
            em, *vecs = self._profile_arrays(p_idx, Kpad)
            emt = em.T.copy()
            emt[NUM_AMINO] = 0.0
            emt[NUM_AMINO, self.hmms[p_idx].length:] = _NEG
            tv = torch.from_numpy(np.stack(vecs)).to(self.device)
            tv = torch.cat([tv, torch.stack(dd_sums(tv[TV_DD]))])
            self._tables[key] = (torch.from_numpy(emt).to(self.device), tv)
        return self._tables[key]

    OMEGA = 1.0 / 256.0  # HMMER3 null2 prior (p7_bg.c default)

    def _inputs(self, p_idx: int, amino_seq: str):
        """The residue rows (L,) int32, the special-state scores (10) and
        Kpad of one hit (the reference's `_inputs` without its emission
        plane)."""
        hmm = self.hmms[p_idx]
        L = len(amino_seq)
        Kpad = _pad_pow2(hmm.length)
        idx = np.array([AMINO_INDEX.get(a, NUM_AMINO) for a in amino_seq],
                       np.int32)
        x = xtrans_setup(True, False, L)
        xvals = (x.NN, x.NB, x.EJ + x.JJ, x.JJ, x.JB, x.EJ + x.JB,
                 x.EC + x.CC, x.CC, x.EC + x.CT, x.CT)
        return idx, xvals, Kpad

    def launch_args(self, p_idx: int, amino_seq: str) -> dict:
        """The device arguments of one hit for amino_forward and
        amino_posterior (a batch of one)."""
        return self._staged([(p_idx, amino_seq)])[0]

    def _staged(self, hits) -> tuple[dict, torch.Tensor]:
        """(device arguments, host buffer) of a batch of non-empty hits
        [(p_idx, amino_seq)] of one Kpad: each hit's cached device tables
        stacked on the device, and its residues, offsets and specials
        staged in one host buffer (pinned for a card) and copied without
        blocking.  The caller holds the buffer until it has fetched the
        launch's output (PyTorch's pinned allocator also keeps the block
        until the copy's event)."""
        inputs = [self._inputs(p, q) for p, q in hits]
        Kpad = inputs[0][2]
        if any(k != Kpad for _, _, k in inputs):
            raise ValueError("a launch takes hits of one Kpad")
        tables = [self._device_arrays(p, Kpad) for p, _ in hits]
        H = len(hits)
        lens = [len(idx) for idx, _, _ in inputs]
        n = sum(lens)
        cuda = self.device.type == "cuda"
        host = torch.empty((n + H + 1 + 10 * H,), dtype=torch.int32,
                           pin_memory=cuda)
        words = host.numpy()
        words[:n] = np.concatenate([idx for idx, _, _ in inputs])
        words[n:n + H + 1] = np.concatenate([[0], np.cumsum(lens)])
        words[n + H + 1:].view(np.float32)[:] = np.asarray(
            [x for _, x, _ in inputs], np.float32).ravel()
        dev = host.to(self.device, non_blocking=True) if cuda else host
        return dict(
            em=torch.stack([em for em, _ in tables]),
            tv=torch.stack([tv for _, tv in tables]), res=dev[:n],
            off=dev[n:n + H + 1],
            xv=dev[n + H + 1:].view(torch.float32).reshape(H, 10)), host

    def launch_plan(self, hits, posterior: bool = False) -> list[list[int]]:
        """The indices of the non-empty `hits` that each launch takes: one
        launch a Kpad group (`kpad_groups`), a posterior group in as many
        as POSTERIOR_SCRATCH_BYTES asks (`budget_chunks`)."""
        plan = []
        for Kpad, ids in kpad_groups([_pad_pow2(self.hmms[p].length)
                                      for p, _ in hits]):
            plan += (budget_chunks(ids, [len(hits[i][1]) for i in ids], Kpad,
                                   POSTERIOR_SCRATCH_BYTES)
                     if posterior else [ids])
        return plan

    def _launch_groups(self, hits, fn, posterior: bool = False):
        """Run `fn` (amino_forward, or amino_posterior with `posterior`) on
        the non-empty `hits` as `launch_plan` says; every launch is made
        before any output is fetched.  Returns each hit's output row
        (numpy), in order."""
        launched = []
        for run in self.launch_plan(hits, posterior):
            args, host = self._staged([hits[i] for i in run])
            launched.append((run, fn(**args), host))
        rows = [None] * len(hits)
        for ids, out, _ in launched:
            for i, row in zip(ids, to_host(out)):
                rows[i] = row
        return rows

    def posterior_usages(self, p_idx: int, amino_seq: str):
        """(fwd_nats, gM (Kpad,), gI_total, gNCJ_total) posterior residue
        usages; gM.sum() + gI + gNCJ == len(seq) (each residue is emitted
        by exactly one emitting state)."""
        return self.posterior_usages_many([(p_idx, amino_seq)])[0]

    def posterior_usages_many(self, hits) -> list[tuple]:
        """posterior_usages of each non-empty hit [(p_idx, amino_seq)],
        one posterior launch a Kpad group (more past the scratch
        budget)."""
        return [(float(o[0]), o[3:], float(o[1]), float(o[2]))
                for o in self._launch_groups(hits, amino_posterior,
                                             posterior=True)]

    def null2_bias_nats(self, p_idx: int, amino_seq: str,
                        fwd_and_usages=None) -> float:
        """HMMER3-style null2 bias (p7_null2.c p7_Null2_ByExpectation):
        state usages averaged over the sequence, expected per-residue-type
        odds under the posterior-weighted emission model, per-residue log
        corrections summed, mixed with the omega prior
        (p7_domaindef.c: seqbias = FLogsum(0, log(omega) + domcorrection)).
        """
        L = len(amino_seq)
        if L == 0:
            return 0.0
        if fwd_and_usages is None:
            fwd_and_usages = self.posterior_usages(p_idx, amino_seq)
        _, gM, gI, gNCJ = fwd_and_usages
        em, *_ = self._profile_arrays(p_idx, _pad_pow2(
            self.hmms[p_idx].length))
        odds = np.exp(np.minimum(em[:, :NUM_AMINO].astype(np.float64), 60.0))
        r2 = (gM.astype(np.float64) @ odds + (gI + gNCJ)) / max(L, 1)
        idx = np.array([AMINO_INDEX.get(a, NUM_AMINO) for a in amino_seq],
                       np.int32)
        logr2 = np.log(np.maximum(r2, 1e-300))
        correction = float(logr2[idx[idx < NUM_AMINO]].sum())
        return float(np.logaddexp(0.0, math.log(self.OMEGA) + correction))

    def bit_score(self, p_idx: int, amino_seq: str,
                  null2: bool = False) -> float:
        return self.bit_scores([(p_idx, amino_seq)], null2=null2)[0]

    def bit_scores(self, hits, null2: bool = False) -> list[float]:
        """bit_score of each hit [(p_idx, amino_seq)]: the non-empty ones
        in one launch a Kpad group (the posterior with null2, else the
        Forward); an empty string scores -inf without a launch."""
        live = [i for i, (_, q) in enumerate(hits) if q]
        scores = [-math.inf] * len(hits)
        if not live:
            return scores
        sub = [hits[i] for i in live]
        if null2:
            usages = self.posterior_usages_many(sub)
            parts = [(u[0], self.null2_bias_nats(p, q, u))
                     for (p, q), u in zip(sub, usages)]
        else:
            fwd = self._launch_groups(sub, amino_forward)
            parts = [(float(f), 0.0) for f in fwd]
        for i, (_, q), (fwd_nats, bias) in zip(live, sub, parts):
            scores[i] = self.score_bits(len(q), fwd_nats, bias)
        return scores

    @staticmethod
    def score_bits(L: int, fwd_nats: float, bias: float) -> float:
        """The bit score of a hit of L > 0 residues from its Forward and
        null2 bias nats."""
        null_len = L * math.log(L / (L + 1.0)) + math.log(1.0 / (L + 1.0))
        # hmmpgmd score-convention correction (the reference's bit_score):
        # this model's forward exceeds hmmpgmd's reported full-sequence bit
        # score by ln(L) nats, fitted on real hmmpgmd stats
        return (fwd_nats - math.log(L) - null_len - bias) / LN2

    def log_evalue(self, p_idx: int, score: float, Z: float = 1.0) -> float:
        """log E of a bit score from the FORWARD calibration line."""
        stats = self.hmms[p_idx].stats.get("FORWARD")
        if stats is None:
            raise ValueError("profile lacks STATS LOCAL FORWARD calibration")
        tau, lam = stats
        # exponential tail in bits: P = exp(-lambda * (S - tau))
        ln_p = min(-lam * (score - tau), 0.0)
        return ln_p + math.log(Z)

    def evalue(self, p_idx: int, amino_seq: str, Z: float = 1.0,
               null2: bool = False):
        """(bit_score, log_evalue) from the FORWARD calibration line."""
        s = self.bit_score(p_idx, amino_seq, null2=null2)
        return s, self.log_evalue(p_idx, s, Z)


class NativeConfirmer:
    """Drop-in `confirmer` for Scanner: native Forward e-values.

    Keep policy mirrors the reference flags (c-core/hmmer.c:86-92): with
    GA thresholds, keep when bit score >= GA sequence cutoff; otherwise
    keep when evalue <= cutoff with Z = num_proteins.  Returns
    (logevalue, h3r_blob); logevalue == 0 means "rejected" to the scan
    pipeline (thread.c:200).  `device` as AminoForwardScorer's.
    """

    def __init__(self, hmms: list[HMMProfile], num_proteins: int | None = None,
                 evalue_cutoff: float = 1e-10, null2: bool = True,
                 device="cuda"):
        self.scorer = AminoForwardScorer(hmms, device=device)
        self.hmms = hmms
        self.num_proteins = num_proteins or len(hmms)
        self.evalue_cutoff = evalue_cutoff
        self.null2 = null2

    def confirm(self, p_idx: int, amino_seq: str):
        return self.confirm_many([(p_idx, amino_seq)])[0]

    def confirm_many(self, hits) -> list[tuple]:
        """confirm of each hit [(p_idx, amino_seq)], in order: the scores
        of all of them first (one launch a Kpad group), then the keep
        policy hit by hit."""
        from .h3result import H3Result

        out = []
        for (p_idx, amino_seq), score in zip(
                hits, self.scorer.bit_scores(hits, null2=self.null2)):
            hmm = self.hmms[p_idx]
            Z = 1.0 if hmm.has_ga else float(self.num_proteins)
            logevalue = self.scorer.log_evalue(p_idx, score, Z)
            drop = (score < hmm.ga[0] if hmm.has_ga
                    else logevalue > math.log(self.evalue_cutoff))
            if drop or logevalue >= 0.0:
                out.append((0.0, None))
                continue
            h3r = H3Result.single_hit(
                name=hmm.name, acc=hmm.accession, score=score,
                lnP=logevalue - math.log(Z), Z=Z, qlen=hmm.length,
                seqlen=len(amino_seq))
            out.append((logevalue, h3r.to_blob()))
        return out
