"""Traceback from the packed trellis: host walk (oracle) + device walk.

Counterpart of deciphon_tpu/ops/traceback.py (which loads jax at import):

  * `unzip` — host numpy walk, the oracle (trellis.c:147-167);
  * `walk`  — the batched device walk: the CUDA kernel
    csrc/traceback_walk.cu (one warp per survivor, reading the trellis
    from shared-memory tiles) on CUDA tensors, `walk_plain` (a vectorised
    torch loop over the batch) on CPU tensors;
  * `fetch_steps` / `assemble_path_entries` / `path_arrays` — the step
    arrays, fetched in one transfer, to the (sids, sizes) arrays the scan
    pipeline decodes.

The walk reads the path kernel's trellis in place: xnode (R, Lk) and node
(R, Lk, Kp) int32 with rows selected by `rows`; stage s reads row s-1 and
stage 0 is an all-zero row.  A walk that overflows `max_steps` reports
ok = False and is walked again by `rewalk`, on the trellis's own device,
with twice the steps until it ends; one that underflows its stage means a
corrupt trellis and raises.  `REWALKS` counts the re-walked survivors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import states as st

from .viterbi import LAUNCHES, on_cuda

# survivors whose first walk overflowed and went through `rewalk`
REWALKS = {"survivors": 0}

# xnode field offsets/widths: N(4@0) B(2@4) E(15@6) C(4@21) T(1@25) J(4@26)
_XN = {
    st.STATE_N: (0, 4),
    st.STATE_B: (4, 2),
    st.STATE_E: (6, 15),
    st.STATE_C: (21, 4),
    st.STATE_T: (25, 1),
    st.STATE_J: (26, 4),
}
# node fields: M(5@0) D(1@5) I(4@6)
_ND_M = (0, 5)
_ND_D = (5, 1)
_ND_I = (6, 4)


def _bits(x, off: int, width: int):
    return (x >> off) & ((1 << width) - 1)


def unzip(xnodes: np.ndarray, nodes: np.ndarray, L: int,
          K: int) -> list[tuple[int, int]]:
    """Walk T back to S; return the forward path as [(state_id, seqsize)].

    xnodes: (L+1,) uint32; nodes: (L+1, K) uint16.
    """
    path: list[tuple[int, int]] = []
    state = st.STATE_T
    stage = L
    while not (state == st.STATE_S and stage == 0):
        size = _emission_size(xnodes, nodes, stage, state)
        path.append((state, size))
        state = _previous_state(xnodes, nodes, stage, state, K)
        stage -= size
        if stage < 0:
            raise RuntimeError("traceback underflow: corrupt trellis")
    path.append((state, 0))
    path.reverse()
    return path


def _emission_size(xnodes, nodes, stage, sid) -> int:
    if sid in (st.STATE_S, st.STATE_B, st.STATE_E, st.STATE_T):
        return 0
    x = int(xnodes[stage])
    if sid in (st.STATE_N, st.STATE_C, st.STATE_J):
        return _bits(x, *_XN[sid]) % 5 + 1
    if st.is_delete(sid):
        return 0
    n = int(nodes[stage, st.core_idx(sid)])
    if st.is_match(sid):
        return _bits(n, *_ND_M) % 5 + 1
    if st.is_insert(sid):
        return _bits(n, *_ND_I) % 5 + 1
    raise AssertionError(sid)


def _previous_state(xnodes, nodes, stage, sid, K) -> int:
    if not st.is_core(sid):
        if sid == st.STATE_S:
            return st.STATE_S
        v = _bits(int(xnodes[stage]), *_XN[sid])
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
        if sid == st.STATE_J:
            return (st.STATE_E, st.STATE_J)[v // 5]
        raise AssertionError(sid)

    idx = st.core_idx(sid)
    n = int(nodes[stage, idx])
    if st.is_match(sid):
        choice = _bits(n, *_ND_M) // 5
        if choice == 0:
            return st.STATE_B
        assert idx > 0, "M1 must come from B"
        return (None, st.make_match_id, st.make_insert_id,
                st.make_delete_id)[choice](idx - 1)
    if st.is_delete(sid):
        assert idx > 0
        return (st.make_match_id,
                st.make_delete_id)[_bits(n, *_ND_D)](idx - 1)
    if st.is_insert(sid):
        return (st.make_match_id,
                st.make_insert_id)[_bits(n, *_ND_I) // 5](idx)
    raise AssertionError(sid)


# ---------------------------------------------------------------------------
# Batched walk
# ---------------------------------------------------------------------------

_S, _N, _B, _E, _J, _C, _T = (st.STATE_S, st.STATE_N, st.STATE_B, st.STATE_E,
                              st.STATE_J, st.STATE_C, st.STATE_T)
_CLS_M, _CLS_I, _CLS_D = (st.STATE_M >> 14, st.STATE_I >> 14,
                          st.STATE_D >> 14)


def _step_fields(state, x, nd):
    """(size, prev_state) of one walk step for a batch (trellis.c:51-113),
    `x`/`nd` the xnode and node words at the current stage."""
    w = torch.where
    cls = (state >> 14) & 3
    idx = (state & 0x3FFF) - 1

    def mk(cls_bits, k):
        return (cls_bits << 14) | (k + 1)

    size = w(cls == _CLS_M, _bits(nd, 0, 5) % 5 + 1,
             w(cls == _CLS_I, _bits(nd, 6, 4) % 5 + 1,
               w(cls == _CLS_D, 0,
                 w(state == _N, _bits(x, 0, 4) % 5 + 1,
                   w(state == _C, _bits(x, 21, 4) % 5 + 1,
                     w(state == _J, _bits(x, 26, 4) % 5 + 1, 0))))))
    bv = _bits(x, 4, 2)
    ev = _bits(x, 6, 15)
    prev_x = w(state == _N, w(_bits(x, 0, 4) // 5 == 0, _S, _N),
               w(state == _B, w(bv == 0, _S, w(bv == 1, _N,
                                               w(bv == 2, _E, _J))),
                 w(state == _E, w(ev % 2 == 0, mk(_CLS_M, ev // 2),
                                  mk(_CLS_D, ev // 2)),
                   w(state == _C, w(_bits(x, 21, 4) // 5 == 0, _E, _C),
                     w(state == _T, w(_bits(x, 25, 1) == 0, _E, _C),
                       w(state == _J, w(_bits(x, 26, 4) // 5 == 0, _E, _J),
                         _S))))))
    mc = _bits(nd, 0, 5) // 5  # 0 B, 1 M, 2 I, 3 D
    prev_m = w(mc == 0, _B, w(mc == 1, mk(_CLS_M, idx - 1),
                              w(mc == 2, mk(_CLS_I, idx - 1),
                                mk(_CLS_D, idx - 1))))
    prev_d = w(_bits(nd, 5, 1) == 0, mk(_CLS_M, idx - 1),
               mk(_CLS_D, idx - 1))
    prev_i = w(_bits(nd, 6, 4) // 5 == 0, mk(_CLS_M, idx),
               mk(_CLS_I, idx))
    prev = w(cls == _CLS_M, prev_m,
             w(cls == _CLS_D, prev_d, w(cls == _CLS_I, prev_i, prev_x)))
    return size, prev


def walk_plain(xn, nd, rows, lengths, max_steps: int):
    """Plain PyTorch walk: every survivor steps together, one vectorised
    step per loop turn, until all are done.  Same outputs as `walk`."""
    B = rows.shape[0]
    Kp = nd.shape[2]
    dev = xn.device
    i64 = torch.int64
    r = rows.long()
    state = torch.full((B,), _T, dtype=i64, device=dev)
    stage = lengths.long().clone()
    n = torch.zeros((B,), dtype=i64, device=dev)
    alive = stage > 0
    sts = torch.zeros((B, max_steps), dtype=torch.int16, device=dev)
    szs = torch.zeros((B, max_steps), dtype=torch.int8, device=dev)
    ar = torch.arange(B, device=dev)
    while bool(alive.any()):
        row = (stage - 1).clamp(min=0)
        has = stage > 0
        x = torch.where(has, xn[r, row].long(), 0)
        idc = ((state & 0x3FFF) - 1).clamp(0, Kp - 1)
        ndv = torch.where(has, nd[r, row, idc].long(), 0)
        size, prev = _step_fields(state, x, ndv)
        a = ar[alive]
        sts[a, n[alive]] = state[alive].to(torch.int16)
        szs[a, n[alive]] = size[alive].to(torch.int8)
        stage2 = stage - size
        n2 = n + 1
        done = (prev == _S) & (stage2 == 0)
        bad = (stage2 < 0) | (n2 >= max_steps)
        state = torch.where(alive, prev, state)
        stage = torch.where(alive, stage2, stage)
        n = torch.where(alive, n2, n)
        alive = alive & ~(done | bad)
    oks = ((state == _S) & (stage == 0)).to(torch.uint8)
    return sts, szs, n.to(torch.int32), oks


def walk(xn, nd, rows, lengths, max_steps: int):
    """Batched traceback of survivors.

    xn (R, Lk) / nd (R, Lk, Kp) int32 trellis, rows (B,) int32 selecting
    each survivor's row, lengths (B,) int32.  Returns (states (B,
    max_steps) int16 holding uint16 bits, sizes (B, max_steps) int8,
    nsteps (B,) int32, ok (B,) uint8), steps in T..S order."""
    R, Lk = xn.shape
    Kp = nd.shape[2]
    B = rows.shape[0]
    for t, name, shape in ((xn, "xn", (R, Lk)), (nd, "nd", (R, Lk, Kp)),
                           (rows, "rows", (B,)), (lengths, "lengths", (B,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                             f"contiguous int32 {shape}")
    if not on_cuda(xn, nd, rows, lengths):
        return walk_plain(xn, nd, rows, lengths, max_steps)
    from .. import _build

    dev = xn.device
    sts = torch.zeros((B, max_steps), dtype=torch.int16, device=dev)
    szs = torch.zeros((B, max_steps), dtype=torch.int8, device=dev)
    ns = torch.empty((B,), dtype=torch.int32, device=dev)
    oks = torch.empty((B,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().dtt_walk(
            xn.data_ptr(), nd.data_ptr(), rows.data_ptr(),
            lengths.data_ptr(), sts.data_ptr(), szs.data_ptr(),
            ns.data_ptr(), oks.data_ptr(), B, Lk, Kp, max_steps,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dtt_walk")
    LAUNCHES["walk"] += 1
    return sts, szs, ns, oks


def host_trellis(xn: np.ndarray, nd: np.ndarray, L: int):
    """One survivor's trellis rows as `unzip` takes them: the zero stage-0
    row prepended, (L+1,) uint32 and (L+1, Kp) uint16."""
    x = np.zeros(L + 1, np.uint32)
    x[1:] = xn[:L].astype(np.uint32)
    n = np.zeros((L + 1, nd.shape[1]), np.uint16)
    n[1:] = nd[:L].astype(np.uint16)
    return x, n


def rewalk(xn, nd, rows: list[int], lengths: list[int], max_steps: int):
    """Walk again the survivors whose walk overflowed `max_steps`, with
    twice the steps each round, on the trellis's device (the kernel on the
    card).  Returns host (states as uint16, sizes, nsteps) arrays.  No valid
    path is longer than Lk * (Kp + 4) + 64 steps: at most Kp + 4 mute
    steps (deletes, B, E) come between two emitting ones."""
    Lk, Kp = nd.shape[1], nd.shape[2]
    limit = Lk * (Kp + 4) + 64
    rows_t = torch.tensor(rows, dtype=torch.int32).to(xn.device)
    lens_t = torch.tensor(lengths, dtype=torch.int32).to(xn.device)
    REWALKS["survivors"] += len(rows)
    while True:
        max_steps = min(2 * max_steps, limit)
        sts, szs, ns, oks = (a.cpu().numpy() for a in
                             walk(xn, nd, rows_t, lens_t, max_steps))
        if oks.all():
            return sts.view(np.uint16), szs, ns
        if max_steps == limit or (ns[oks == 0] < max_steps).any():
            raise RuntimeError("traceback underflow: corrupt trellis")


def fetch_steps(entries) -> list[np.ndarray]:
    """Host copies of the step arrays (sts, szs, ns, oks) of every path
    entry, in order, through ONE device-to-host transfer."""
    flat = [a for e in entries for a in e[1:5]]
    sizes = [a.numel() * a.element_size() for a in flat]
    buf = torch.cat([a.reshape(-1).view(torch.uint8)
                     for a in flat]).cpu().numpy()
    fetched, pos = [], 0
    for a, nb in zip(flat, sizes):
        dt = {torch.int16: np.int16, torch.int8: np.int8,
              torch.int32: np.int32, torch.uint8: np.uint8}[a.dtype]
        fetched.append(buf[pos:pos + nb].view(dt).reshape(a.shape))
        pos += nb
    return fetched


def assemble_path_entries(entries, fetched, out: dict) -> None:
    """Fetched path entries -> {id(item): (sids, sizes)}.

    `entries` are (items, sts, szs, ns, oks, xn, nd, rows, lengths) from
    a scorer's path launches; `fetched` holds the host numpy copies
    of (sts, szs, ns, oks) per entry, in order.  Walks that overflowed go
    through `rewalk`."""
    for i, e in enumerate(entries):
        items, _, _, _, _, xn, nd, rows, lengths = e
        sts, szs, ns, oks = fetched[4 * i:4 * i + 4]
        steps = {b: (sts[b].view(np.uint16), szs[b], ns[b])
                 for b in range(len(items))}
        bad = np.flatnonzero(oks == 0).tolist()
        if bad:
            again = rewalk(xn, nd, [rows[b] for b in bad],
                           [lengths[b] for b in bad], sts.shape[1])
            for j, b in enumerate(bad):
                steps[b] = (again[0][j], again[1][j], again[2][j])
        for b, it in enumerate(items):
            # the walk emits T..S order: reverse and prepend S
            s, z, n = steps[b]
            n = int(n)
            sid = np.empty(n + 1, np.int64)
            sz = np.empty(n + 1, np.int64)
            sid[0], sz[0] = st.STATE_S, 0
            sid[1:] = s[n - 1::-1]
            sz[1:] = z[n - 1::-1]
            out[id(it)] = (sid, sz)


def path_arrays(steps):
    """(state, size) step list -> (sids (n,) int64, sizes (n,) int64)."""
    a = np.asarray(steps, np.int64).reshape(-1, 2)
    return np.ascontiguousarray(a[:, 0]), np.ascontiguousarray(a[:, 1])
