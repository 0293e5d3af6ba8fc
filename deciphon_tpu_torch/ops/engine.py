"""Stacked multi-profile scan engine in plain PyTorch.

Counterpart of deciphon_tpu/ops/engine.py: profiles padded to a common
node count and stacked, so one call scores a (P profiles x B windows) tile
with the lax.scan engine's recurrence (ops/viterbi_torch.py), every pair
as one row of the batch.  `TorchPairScorer` (scan/scheduler.py) scores
through it, and the dense grid kernel (ops/viterbi.py GridScanEngine, B9)
is held against it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..frame import TABLE_SIZE
from ..xtrans import XT_RR
from .costs import CT_DD, CT_DDCUM, NUM_TRANS_VECS, ViterbiCosts, dd_cum_row
from .viterbi_torch import run, run_null

INF = np.float32(np.inf)


@dataclass
class ProfilePack:
    """A stack of P pressed profiles padded to a common K (host arrays).

    Pad nodes carry +inf transition and emission costs, so they never lie
    on an optimal path."""

    K_pad: int
    core: np.ndarray  # (P, 9, K_pad) f32 costs
    match: np.ndarray  # (P, 1364, K_pad) f32 costs
    null: np.ndarray  # (P, 1364) f32 costs
    background: np.ndarray  # (P, 1364) f32 costs
    core_sizes: np.ndarray  # (P,) int32 true K per profile

    @property
    def num_profiles(self) -> int:
        return self.core.shape[0]

    @classmethod
    def from_costs(cls, costs: list[ViterbiCosts], K_pad: int | None = None,
                   lane_multiple: int = 128) -> "ProfilePack":
        kmax = max(c.K for c in costs)
        if K_pad is None:
            K_pad = -(-kmax // lane_multiple) * lane_multiple
        if K_pad < kmax:
            raise ValueError(f"K_pad={K_pad} below the largest K={kmax}")
        P = len(costs)
        core = np.full((P, NUM_TRANS_VECS, K_pad), INF, np.float32)
        match = np.full((P, TABLE_SIZE, K_pad), INF, np.float32)
        null = np.empty((P, TABLE_SIZE), np.float32)
        background = np.empty((P, TABLE_SIZE), np.float32)
        sizes = np.empty((P,), np.int32)
        for i, c in enumerate(costs):
            core[i, :, : c.K] = c.core
            match[i, :, : c.K] = c.match
            null[i] = c.null
            background[i] = c.background
            sizes[i] = c.K
            # an +inf DDCUM entry would turn the delete chain's A - DDCUM
            # into NaN: recompute the saturated cumsum over the padded DD
            # row, which goes on in huge finite steps past K
            dd_pad = np.full((K_pad,), INF, np.float32)
            dd_pad[: c.K] = c.core[CT_DD]
            core[i, CT_DDCUM] = dd_cum_row(dd_pad)
        return cls(K_pad=K_pad, core=core, match=match, null=null,
                   background=background, core_sizes=sizes)


def scan_scores(core, match, null, background, xt, codes, lengths):
    """Score a (P, B) tile on the device of its tensors.

    core (P, 9, K) f32; match (P, 1364, K); null/background (P, 1364); xt
    (B, 13) f32 per-window special costs; codes (B, Lpad, 5) int32
    END-indexed fragment codes; lengths (B,) int.  Returns (null_costs,
    alt_costs), both (P, B) f32."""
    P, B = core.shape[0], codes.shape[0]
    dev = core.device
    pidx = torch.arange(P, device=dev).repeat_interleave(B)
    widx = torch.arange(B, device=dev).repeat(P)
    alt = run(core, match, null, background, pidx, xt, codes, lengths, widx)
    nul = run_null(null, pidx, xt[:, XT_RR].contiguous(), codes, lengths,
                   widx)
    return nul.reshape(P, B), alt.reshape(P, B)


def lrt_tile(null_costs, alt_costs):
    """LRT = 2*(null - alt) on min-plus costs (c-core/lrt.h)."""
    return 2.0 * (null_costs - alt_costs)
