"""Frame Viterbi in plain PyTorch: the benchmark's reference engine.

A frozen copy of the min-plus recurrence of deciphon_tpu/ops/viterbi_jax.py
(the lax.scan engine; deciphon_tpu_torch/ops/viterbi_torch.py is the
port's copy of it), in its logical form:

  position l = 1..L, durations t = 1..5, fragment code c(l,t) = seq[l-t, l):

    N_l = min_t min(S_{l-t}+SN, N_{l-t}+NN) + null[c]
    J_l = min_t min(E_{l-t}+EJ, J_{l-t}+JJ) + null[c]
    C_l = min_t min(E_{l-t}+EC, C_{l-t}+CC) + null[c]
    M_l[k] = min_t [min(B_{l-t}+BM[k], M_{l-t}[k-1]+MM[k],
                        I_{l-t}[k-1]+IM[k], D_{l-t}[k-1]+DM[k]) + match[c,k]]
    I_l[k] = min_t [min(I_{l-t}[k]+II[k], M_{l-t}[k]+MI[k]) + bg[c]]
    D_l[k] = cummin_k(M_l[k-1]+MD[k] - DDCUM[k]) + DDCUM[k]
    E_l = min_k min(M_l[k], D_l[k]);  B_l = min(N_l+NB, E_l+EB, J_l+JB)
    T_l = min(E_l+ET, C_l+CT)

One Python step per DP position; the rows (profile x window pairs) are a
leading dimension.  Every candidate keeps the f32 grouping of the JAX
package's engine -- (state + trans) + emission, the delete chain as
cummin(A - DDCUM) + DDCUM, the null model as min_t((R + RR) + nil) -- so a
correct scan on the card agrees with it bit for bit.  Path mode emits the
packed trellis (c-core/state.h:28-39) as int32 planes with first-minimum
tie-breaks.  `dtype` computes every cost in another floating type (the
control runs it in bfloat16).

Inputs are tensors on one device: core (P, 9, K) f32 in costs.py's row
order, match (P, 1364, K), null and background (P, 1364), xt (B, 13),
codes (B, Lpad, 5) int32 END-indexed fragment codes, lengths (B,).
"""

from __future__ import annotations

import torch

from .xtrans import (XT_CC, XT_CT, XT_EB, XT_EC, XT_EJ, XT_ET, XT_JB, XT_JJ,
                      XT_NB, XT_NN, XT_RR, XT_SB, XT_SN)
from .costs import (CT_BM, CT_DDCUM, CT_DM, CT_II, CT_IM, CT_MD, CT_MI,
                    CT_MM)

INF = float("inf")
TABLE_ROWS = 1364  # frame.TABLE_SIZE


def _shift_k(x: torch.Tensor) -> torch.Tensor:
    """Node shift: out[..., k] = x[..., k-1], out[..., 0] = +inf."""
    pad = torch.full(x.shape[:-1] + (1,), INF, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def _order2(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """(R, 5) candidates per duration (t = 1..5 along dim 1) of two sources
    -> (R, 10) in the reference's scan order: t descending, c0 then c1."""
    return torch.stack([c0, c1], dim=-1).flip(1).reshape(c0.shape[0], 10)


def _first_min(cands: torch.Tensor, dim: int):
    """Minimum and the index of its first occurrence along `dim`."""
    best, idx = cands.min(dim)
    return best, idx.to(torch.int32)


def run(core, match, null, background, pidx, xt, codes, lengths, widx=None,
        path: bool = False, dtype=torch.float32):
    """The engine over R rows: row r scores window widx[r] (default r)
    against profile pidx[r].

    core (P, 9, K), match (P, 1364, K), null/background (P, 1364); pidx
    (R,) int64; xt (B, 13); codes (B, Lpad, 5) int32; lengths (B,) int;
    widx (R,) int64 or None.  Returns T (R,) f32, and in path mode also
    xnodes (R, Lpad+1) and nodes (R, Lpad+1, K) int32."""
    core, match, null, background, xt = (
        a.to(dtype) for a in (core, match, null, background, xt))
    dev = core.device
    P, _, K = core.shape
    Lpad = codes.shape[1]
    R = pidx.shape[0]
    if widx is None:
        widx = torch.arange(R, device=dev)
    xr = xt[widx]  # (R, 13)
    lens = lengths.to(torch.int64)[widx]

    def trans(row):
        return core[:, row][pidx]  # (R, K)

    BM, MM, MI, MD = trans(CT_BM), trans(CT_MM), trans(CT_MI), trans(CT_MD)
    IM, II, DM = trans(CT_IM), trans(CT_II), trans(CT_DM)
    DD_cum = trans(CT_DDCUM)
    flat_match = match.reshape(P * TABLE_ROWS, K)
    base = pidx * TABLE_ROWS  # (R,) table row of code 0
    flat_null = null.reshape(-1)
    flat_bg = background.reshape(-1)

    def x(j):
        return xr[:, j:j + 1]  # (R, 1) against (R, 5) candidates

    ts = torch.arange(1, 6, device=dev)
    # rings, entry t-1 = position l-t; updated in place by `step`
    Mr = torch.full((R, 5, K), INF, dtype=dtype, device=dev)
    Ir, Dr = Mr.clone(), Mr.clone()
    Nr = torch.full((R, 5), INF, dtype=dtype, device=dev)
    Jr, Er, Cr = Nr.clone(), Nr.clone(), Nr.clone()
    Br = Nr.clone()
    T_final = torch.full((R,), INF, dtype=dtype, device=dev)
    rings = (Mr, Ir, Dr, Nr, Jr, Er, Cr, Br)
    pos = torch.ones((), dtype=torch.int64, device=dev)  # l
    if path:
        i32 = torch.int32
        xnodes = torch.zeros((R, Lpad + 1), dtype=i32, device=dev)
        nodes = torch.zeros((R, Lpad + 1, K), dtype=i32, device=dev)

    def reset():
        for r in rings:
            r.fill_(INF)
        Br[:, 0] = xr[:, XT_SB]  # B_0 = SB
        T_final.fill_(INF)
        pos.fill_(1)

    def step():
        l = pos
        valid = ts <= l  # (5,)
        cl = codes.index_select(1, (l - 1).reshape(1))[:, 0]  # (B, 5)
        idx = base[:, None] + cl.long()[widx]  # (R, 5)
        nil = torch.where(valid, flat_null[idx], INF)  # (R, 5)
        bg = torch.where(valid, flat_bg[idx], INF)
        ma = torch.where(valid[:, None], flat_match[idx], INF)  # (R, 5, K)
        S_prev = torch.where(ts == l, 0.0, INF).to(dtype).expand(R, 5)

        n_cands = _order2((S_prev + x(XT_SN)) + nil, (Nr + x(XT_NN)) + nil)
        j_cands = _order2((Er + x(XT_EJ)) + nil, (Jr + x(XT_JJ)) + nil)
        c_cands = _order2((Er + x(XT_EC)) + nil, (Cr + x(XT_CC)) + nil)
        N_l, n_idx = _first_min(n_cands, 1)
        J_l, j_idx = _first_min(j_cands, 1)
        C_l, c_idx = _first_min(c_cands, 1)

        # M: t descending, then BM, MM, IM, DM -> (R, 20, K)
        m_cands = torch.stack([
            (Br[:, :, None] + BM[:, None, :]) + ma,
            (_shift_k(Mr) + MM[:, None, :]) + ma,
            (_shift_k(Ir) + IM[:, None, :]) + ma,
            (_shift_k(Dr) + DM[:, None, :]) + ma,
        ], dim=2).flip(1).reshape(R, 20, K)
        M_l, m_idx = _first_min(m_cands, 1)
        # I: t descending, then II, MI -> (R, 10, K)
        i_cands = torch.stack([
            (Ir + II[:, None, :]) + bg[:, :, None],
            (Mr + MI[:, None, :]) + bg[:, :, None],
        ], dim=2).flip(1).reshape(R, 10, K)
        I_l, i_idx = _first_min(i_cands, 1)

        A = _shift_k(M_l) + MD
        D_l = torch.cummin(A - DD_cum, dim=-1).values + DD_cum

        E_l = torch.minimum(M_l.amin(-1), D_l.amin(-1))
        b_cands = torch.stack([N_l + xr[:, XT_NB], E_l + xr[:, XT_EB],
                               J_l + xr[:, XT_JB]], dim=1)
        B_l, b_idx = _first_min(b_cands, 1)
        t_cands = torch.stack([E_l + xr[:, XT_ET], C_l + xr[:, XT_CT]], dim=1)
        T_l, t_idx = _first_min(t_cands, 1)
        T_final.copy_(torch.where(lens == l, T_l, T_final))

        if path:
            m_choice = m_idx % 4  # 0 BM, 1 MM, 2 IM, 3 DM
            m_t = 5 - m_idx // 4
            i_choice = i_idx % 2  # 0 II, 1 MI
            i_t = 5 - i_idx // 2
            d_is_dd = (D_l < A).to(i32)  # strict: MD wins ties
            _, e_idx = _first_min(torch.stack([M_l, D_l], -1)
                                  .reshape(R, 2 * K), 1)  # 2k + isD

            def field(i):
                return (i % 2) * 5 + (5 - i // 2 - 1)

            xw = (field(n_idx) | ((b_idx + 1) << 4) | (e_idx << 6)
                  | (field(c_idx) << 21) | (t_idx << 25)
                  | (field(j_idx) << 26))
            nw = ((m_choice * 5 + (m_t - 1)) | (d_is_dd << 5)
                  | (((1 - i_choice) * 5 + (i_t - 1)) << 6))
            at = l.reshape(1)
            xnodes.index_copy_(1, at, xw[:, None])
            nodes.index_copy_(1, at, nw[:, None])

        # rotate rings: the newest position takes entry 0
        for ring, new in zip(rings, (M_l, I_l, D_l, N_l, J_l, E_l, C_l,
                                     B_l)):
            ring.copy_(torch.cat([new[:, None], ring[:, :-1]], 1))
        pos.add_(1)

    _drive(step, reset, Lpad, dev)
    if path:
        return T_final, xnodes, nodes
    return T_final


def _drive(step, reset, n: int, dev) -> None:
    """Run `step` n times from `reset`'s state.  On a card, one position's
    step is captured once as a CUDA graph and replayed: the same kernels
    on the same buffers, without a host launch for each of them."""
    reset()
    if dev.type != "cuda" or n < 64:
        for _ in range(n):
            step()
        return
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()  # allocate and load every kernel before the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    reset()
    for _ in range(n):
        graph.replay()
    torch.cuda.synchronize(dev)
    del graph


def run_null(null, pidx, RR, codes, lengths, widx=None,
             dtype=torch.float32):
    """Null-model DP over R rows (c-core/viterbi.c:696-719): row r scores
    window widx[r] (default r) with profile pidx[r]'s null costs.

    null (P, 1364); pidx (R,) int64; RR (B,) f32; codes (B, Lpad, 5);
    lengths (B,).  Returns the null path costs (R,)."""
    null, RR = null.to(dtype), RR.to(dtype)
    dev = null.device
    R = pidx.shape[0]
    if widx is None:
        widx = torch.arange(R, device=dev)
    rr = RR[widx][:, None]  # (R, 1)
    lens = lengths.to(torch.int64)[widx]
    flat = null.reshape(-1)
    base = pidx * TABLE_ROWS
    ts = torch.arange(1, 6, device=dev)
    Rr = torch.full((R, 5), INF, dtype=dtype, device=dev)  # entry t-1 = l-t
    R_final = torch.full((R,), INF, dtype=dtype, device=dev)
    pos = torch.ones((), dtype=torch.int64, device=dev)

    def reset():
        Rr.fill_(INF)
        Rr[:, 0] = -rr[:, 0]  # R_0 = -RR
        R_final.fill_(INF)
        pos.fill_(1)

    def step():
        l = pos
        valid = ts <= l
        cl = codes.index_select(1, (l - 1).reshape(1))[:, 0]
        idx = base[:, None] + cl.long()[widx]
        nil = torch.where(valid, flat[idx], INF)
        R_l = ((Rr + rr) + nil).amin(1)
        R_final.copy_(torch.where(lens == l, R_l, R_final))
        Rr.copy_(torch.cat([R_l[:, None], Rr[:, :-1]], 1))
        pos.add_(1)

    _drive(step, reset, codes.shape[1], dev)
    return R_final
