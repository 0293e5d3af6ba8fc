"""The benchmark's plain reference scan: the same products, serially.

For each (profile, read) pair it walks the windows one after another with
the last-hit feedback of c-core/window.c (a frozen copy in window.py):
score the window (null and alternative Viterbi, viterbi.py), keep it when
LRT = 2 (null - alt) >= 0, then trace the path (trellis + host walk),
segment the hit (c-core/thread.c:130-166), decode codons and aminos
(decoder.py) and form the product line.  Pairs advance in lock step: one
window of every pair a round, all scored in one batched call, so a sample
of a few reads against a few profiles costs a few passes over a read.

Everything here is plain PyTorch and NumPy over the benchmark's own
copies; it imports nothing of the program.  `dtype` runs the Viterbi in
another floating type (the control: bfloat16).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import states as st
from .alphabet import disambiguate, prepare_sequence
from .costs import CT_DD, CT_DDCUM, NUM_TRANS_VECS, build_costs, dd_cum_row
from .decoder import Decoder
from .frame import FRAG_OFFSETS, TABLE_SIZE
from .press import FrameProfile
from .viterbi import run, run_null
from .window import WindowCursor
from .xtrans import XT_RR, xtrans_cost_vector

INF = np.float32(np.inf)

# xnode field offsets/widths: N(4@0) B(2@4) E(15@6) C(4@21) T(1@25) J(4@26)
_XN = {st.STATE_N: (0, 4), st.STATE_B: (4, 2), st.STATE_E: (6, 15),
       st.STATE_C: (21, 4), st.STATE_T: (25, 1), st.STATE_J: (26, 4)}


@dataclass(frozen=True)
class Line:
    """One product line, as the comparison reads it."""

    sequence: int
    window: int
    window_start: int
    window_stop: int
    hit_start: int
    hit_stop: int
    profile: str
    lrt: float
    steps: str

    @property
    def key(self) -> tuple:
        return (self.sequence, self.profile, self.window)


def frag_codes_ending(seq: np.ndarray) -> np.ndarray:
    """codes[l-1, t-1] = code of the length-t fragment ending at l."""
    L = len(seq)
    s = seq.astype(np.int64)
    codes = np.zeros((L, 5), dtype=np.int32)
    val = np.zeros(L, dtype=np.int64)
    for t in range(1, 6):
        if t == 1:
            val = s.copy()
        else:
            prev = np.zeros(L, dtype=np.int64)
            prev[t - 1:] = val[t - 2:L - 1]
            val = prev * 4 + s
        valid = np.arange(L) >= t - 1
        codes[valid, t - 1] = FRAG_OFFSETS[t - 1] + val[valid]
    return codes


def _bits(x: int, off: int, width: int) -> int:
    return (x >> off) & ((1 << width) - 1)


def unzip(xnodes: np.ndarray, nodes: np.ndarray, L: int):
    """Walk T back to S over one trellis (c-core/trellis.c:147-167);
    returns the forward path as (sids, sizes) int64 arrays."""
    path = []
    state, stage = st.STATE_T, L
    while not (state == st.STATE_S and stage == 0):
        x = int(xnodes[stage])
        if state in (st.STATE_S, st.STATE_B, st.STATE_E, st.STATE_T):
            size = 0
        elif state in (st.STATE_N, st.STATE_C, st.STATE_J):
            size = _bits(x, *_XN[state]) % 5 + 1
        elif st.is_delete(state):
            size = 0
        else:
            n = int(nodes[stage, st.core_idx(state)])
            size = (_bits(n, 0, 5) if st.is_match(state)
                    else _bits(n, 6, 4)) % 5 + 1
        path.append((state, size))
        state = _previous(x, nodes, stage, state)
        stage -= size
        if stage < 0:
            raise RuntimeError("reference traceback underflow")
    path.append((state, 0))
    path.reverse()
    a = np.asarray(path, np.int64)
    return a[:, 0], a[:, 1]


def _previous(x: int, nodes, stage: int, sid: int) -> int:
    if not st.is_core(sid):
        if sid == st.STATE_S:
            return st.STATE_S
        v = _bits(x, *_XN[sid])
        if sid == st.STATE_N:
            return (st.STATE_S, st.STATE_N)[v // 5]
        if sid == st.STATE_B:
            return (st.STATE_S, st.STATE_N, st.STATE_E, st.STATE_J)[v]
        if sid == st.STATE_E:
            return (st.make_match_id(v // 2) if v % 2 == 0
                    else st.make_delete_id(v // 2))
        if sid == st.STATE_C:
            return (st.STATE_E, st.STATE_C)[v // 5]
        if sid == st.STATE_T:
            return (st.STATE_E, st.STATE_C)[v]
        return (st.STATE_E, st.STATE_J)[v // 5]  # J
    idx = st.core_idx(sid)
    n = int(nodes[stage, idx])
    if st.is_match(sid):
        choice = _bits(n, 0, 5) // 5
        if choice == 0:
            return st.STATE_B
        return (None, st.make_match_id, st.make_insert_id,
                st.make_delete_id)[choice](idx - 1)
    if st.is_delete(sid):
        return (st.make_match_id, st.make_delete_id)[_bits(n, 5, 1)](idx - 1)
    return (st.make_match_id, st.make_insert_id)[_bits(n, 6, 4) // 5](idx)


def segment_hits(sids: np.ndarray, sizes: np.ndarray):
    """(begin, end, hit_start, hit_stop, last_hit_pos, found_hit) over the
    span from the first B to one past the last E; None without a B."""
    b_idx = np.nonzero(sids == st.STATE_B)[0]
    if len(b_idx) == 0:
        return None
    begin = int(b_idx[0])
    hit_start = int(sizes[:begin].sum())
    e_idx = np.nonzero(sids[begin + 1:] == st.STATE_E)[0]
    if len(e_idx) == 0:
        return begin, begin + 1, hit_start, hit_start, hit_start - 1, False
    last_e = begin + 1 + int(e_idx[-1])
    hit_stop = hit_start + int(sizes[begin + 1:last_e].sum())
    return begin, last_e + 1, hit_start, hit_stop, hit_stop - 1, True


class _Tables:
    """The checked profiles' costs stacked on the device, padded to the
    largest K (pad nodes +inf, the delete prefix recomputed over them)."""

    def __init__(self, profiles: list[FrameProfile], multi_hits: bool,
                 hmmer3_compat: bool, device):
        costs = [build_costs(p, multi_hits, hmmer3_compat) for p in profiles]
        K = max(c.K for c in costs)
        P = len(costs)
        core = np.full((P, NUM_TRANS_VECS, K), INF, np.float32)
        match = np.full((P, TABLE_SIZE, K), INF, np.float32)
        for i, c in enumerate(costs):
            core[i, :, :c.K] = c.core
            match[i, :, :c.K] = c.match
            dd = np.full((K,), INF, np.float32)
            dd[:c.K] = c.core[CT_DD]
            core[i, CT_DDCUM] = dd_cum_row(dd)
        dev = torch.device(device)
        self.core = torch.from_numpy(core).to(dev)
        self.match = torch.from_numpy(match).to(dev)
        self.null = torch.from_numpy(np.stack([c.null for c in costs])).to(dev)
        self.bg = torch.from_numpy(
            np.stack([c.background for c in costs])).to(dev)
        self.K = [c.K for c in costs]


def scan_pairs(profiles: dict[int, FrameProfile],
               reads: list[tuple[int, str]],
               pairs: list[tuple[int, int]], *, multi_hits: bool = True,
               hmmer3_compat: bool = False, device="cpu",
               dtype=torch.float32, near: set | None = None,
               near_lrt: float = 0.0) -> list[Line]:
    """The product lines of every (profile index, read index) in `pairs`.

    `profiles` are the reference's own presses by profile index; `reads`
    are (sequence id, nucleotides).  Lines come back sorted by (profile,
    sequence, window), the order of products.tsv.  `near`, if given, gets
    the (sequence id, accession) of every pair with a window whose |LRT|
    is under `near_lrt`."""
    dev = torch.device(device)
    used = sorted({p for p, _ in pairs})
    slot = {p: i for i, p in enumerate(used)}
    tabs = _Tables([profiles[p] for p in used], multi_hits, hmmer3_compat,
                   dev)
    decoders: dict[int, Decoder] = {}
    syms = [prepare_sequence(r) for _, r in reads]
    data = [disambiguate(r) for _, r in reads]
    cursors = {(p, s): WindowCursor(profiles[p].core_size, len(syms[s]))
               for p, s in pairs}
    lines: list[tuple[int, Line]] = []
    live = sorted(cursors)
    while live:
        wins = []
        for key in live:
            w = cursors[key].next()
            if w is not None:
                wins.append((key, w))
        if not wins:
            break
        lrts = _score(tabs, slot, syms, wins, multi_hits, hmmer3_compat,
                      dev, dtype)
        if near is not None:
            near |= {(reads[s][0], profiles[p].accession)
                     for ((p, s), _), v in zip(wins, lrts)
                     if abs(v) < near_lrt}
        surv = [(key, w, v) for (key, w), v in zip(wins, lrts)
                if np.isfinite(v) and v >= 0]
        for (key, w, v), (sids, sizes) in zip(
                surv, _paths(tabs, slot, syms, [(k, w) for k, w, _ in surv],
                             multi_hits, hmmer3_compat, dev, dtype)):
            p, s = key
            seg = segment_hits(sids, sizes)
            if seg is None:
                continue
            begin, end, hit_start, hit_stop, last_hit, found = seg
            cursors[key].set_last_hit_position(last_hit)
            if not found:
                continue
            if p not in decoders:
                decoders[p] = Decoder(profiles[p])
            steps, aminos = _decode(decoders[p], sids, sizes, begin, end,
                                    data[s][w.start:w.stop],
                                    frag_codes_ending(syms[s][w.start:w.stop]))
            if not aminos:
                continue
            lines.append((p, Line(reads[s][0], w.idx, w.start, w.stop,
                                  hit_start, hit_stop, profiles[p].accession,
                                  float(v), ";".join(steps))))
        live = [key for key, _ in wins]
    lines.sort(key=lambda pl: (pl[0], pl[1].sequence, pl[1].window))
    return [ln for _, ln in lines]


def _rows(tabs, slot, syms, wins, multi_hits, hmmer3_compat, dev):
    n = len(wins)
    Lpad = max(w.length for _, w in wins)
    codes = np.zeros((n, Lpad, 5), np.int32)
    xts = np.zeros((n, 13), np.float32)
    lens = np.zeros((n,), np.int64)
    pidx = np.zeros((n,), np.int64)
    for i, ((p, s), w) in enumerate(wins):
        codes[i, :w.length] = frag_codes_ending(syms[s][w.start:w.stop])
        xts[i] = xtrans_cost_vector(multi_hits, hmmer3_compat, w.length)
        lens[i] = w.length
        pidx[i] = slot[p]
    return tuple(torch.from_numpy(a).to(dev) for a in (codes, xts, lens, pidx))


def _score(tabs, slot, syms, wins, multi_hits, hmmer3_compat, dev, dtype):
    """LRT of every window, as the scan computes it from f32 costs."""
    codes, xts, lens, pidx = _rows(tabs, slot, syms, wins, multi_hits,
                                   hmmer3_compat, dev)
    alt = run(tabs.core, tabs.match, tabs.null, tabs.bg, pidx, xts, codes,
              lens, dtype=dtype)
    nul = run_null(tabs.null, pidx, xts[:, XT_RR].contiguous(), codes, lens,
                   dtype=dtype)
    alt = alt.float().cpu().numpy()
    nul = nul.float().cpu().numpy()
    return [2.0 * (float(a) - float(b)) for a, b in zip(nul, alt)]


def _paths(tabs, slot, syms, wins, multi_hits, hmmer3_compat, dev, dtype,
           trellis_bytes: int = 16 << 30):
    """(sids, sizes) of every window's optimal path: windows in calls of
    at most `trellis_bytes` of trellis, each call's tables cut to its
    largest K."""
    out = [None] * len(wins)
    order = sorted(range(len(wins)), key=lambda i: tabs.K[slot[wins[i][0][0]]])
    chunk: list[int] = []

    def flush():
        if not chunk:
            return
        sub = [wins[i] for i in chunk]
        codes, xts, lens, pidx = _rows(tabs, slot, syms, sub, multi_hits,
                                       hmmer3_compat, dev)
        K = max(tabs.K[slot[key[0]]] for key, _ in sub)
        _, xn, nd = run(tabs.core[:, :, :K].contiguous(),
                        tabs.match[:, :, :K].contiguous(), tabs.null,
                        tabs.bg, pidx, xts, codes, lens, path=True,
                        dtype=dtype)
        for r, i in enumerate(chunk):
            L = wins[i][1].length
            out[i] = unzip(xn[r, :L + 1].cpu().numpy().astype(np.uint32),
                           nd[r, :L + 1].cpu().numpy().astype(np.uint16), L)
        chunk.clear()

    for i in order:
        K = tabs.K[slot[wins[i][0][0]]]
        Lmax = max([wins[j][1].length for j in chunk] + [wins[i][1].length])
        Kmax = max([tabs.K[slot[wins[j][0][0]]] for j in chunk] + [K])
        if chunk and (len(chunk) + 1) * (Lmax + 1) * Kmax * 4 > trellis_bytes:
            flush()
        chunk.append(i)
    flush()
    return out


def _decode(decoder: Decoder, sids, sizes, begin: int, end: int,
            window_syms: str, codes_win: np.ndarray):
    """The hit's steps as "frag,STATE,codon,amino" and its amino count."""
    pos0 = int(sizes[:begin].sum())
    sids = sids[begin:end]
    sizes = sizes[begin:end]
    ends = pos0 + np.cumsum(sizes)
    starts = ends - sizes
    steps, aminos = [], []
    for sid, size, a, b in zip(sids.tolist(), sizes.tolist(), starts, ends):
        frag = window_syms[a:b]
        name = st.state_name(sid)
        mute = (st.is_delete(sid) or sid in (st.STATE_S, st.STATE_B,
                                             st.STATE_E, st.STATE_T))
        if mute or size == 0:
            steps.append(f"{frag},{name},,")
            continue
        codon, amino = decoder.decode_codon_amino(
            sid, int(codes_win[b - 1, size - 1]))
        steps.append(f"{frag},{name},{codon},{amino}")
        aminos.append(amino)
    return steps, "".join(aminos)
