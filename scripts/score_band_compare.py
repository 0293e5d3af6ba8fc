#!/usr/bin/env python3
"""Time a DP position of B1, B3, B5, B8 and B9 past Kp 2048 on the card,
this tree's kernels against another checkout's (the parent commit's), in
one process:

    git archive <parent> deciphon_tpu_torch | tar -x -C build/parent
    python scripts/score_band_compare.py build/parent > rows.jsonl

Each checkout's `deciphon_tpu_torch/_build.py` builds its own `csrc/`
into its own `build/`, and the kernels run on the same tensors.  The
parent's B1, B3, B5 and B8 are its lane loop, whose entry points take no
launch shape; its B9 is the clustered score body at WIDE lanes a CTA.
This tree's kernels run in their own shape, `cluster_shape(Kp)`, and
again at WIDE lanes a CTA (the "wide" times), which tells the score
family's width.  Every (kernel, Kp, grid) is timed in turns, parent,
change, change, parent, wide, wide, each the mean of REPS launches
between CUDA events; a position's time is the kernel time over the
positions of the (equal) windows.  Two grids: "full" (264 windows,
enough to fill every SM with either design) and "few" (8 windows).
Every output must be bit-equal across the builds and widths (scores, and
B8's exported carry planes).  Each row also gets its bound: the larger of
34 f32 adds and mins a (position, true node) cell over the card's f32
peak and the bytes moved (tables and transition rows of the profiles,
20 code bytes a position, per-window inputs and outputs) over its memory
rate.  Prints one JSON object a row.  Imports only the port: no JAX.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_F32_OPS = 67e12  # one H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # its HBM3 rate
CELL_OPS = 34  # f32 adds and mins a cell of the score family
KPS = (2176, 2560, 3072, 4096, 5120)
GRIDS = (("full", 264, 400), ("few", 8, 1000))  # (name, windows, positions)
REPS = 3
WIDE = 768  # lanes a CTA of the parent's clustered score body
FN = {"B1": "dtt_score_pairs", "B3": "dtt_score_chained",
      "B5": "dtt_score_mixed", "B8": "dtt_score_chained_carry",
      "B9": "dtt_score_grid"}


def load_build(root: str, name: str):
    """The built library of the checkout at `root` (its `_build` module
    loaded under `name`, so that its paths are its own)."""
    path = os.path.join(root, "deciphon_tpu_torch", "_build.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib()


def inputs(torch, Kp: int, n: int, L: int, seed: int):
    """n windows of L positions over random reads, against two profiles
    (K = Kp - 2 and Kp - 130, both in Kp's lane width): the arguments of
    every form, on the card.  Pair i of B1, B3 and B8 holds profile i % 2,
    B5's slots alternate the profiles, B9 scores every window against
    both."""
    import numpy as np

    from deciphon_tpu_torch.ops.costs import build_costs
    from deciphon_tpu_torch.ops.tables import stack_tables
    from deciphon_tpu_torch.ops.viterbi import CW
    from deciphon_tpu_torch.profile import sample_profile
    from deciphon_tpu_torch.workload import window_batch

    rng = np.random.default_rng(seed)
    ks = (Kp - 2, Kp - 130)
    costs = [build_costs(sample_profile(seed + i, k))
             for i, k in enumerate(ks)]
    tables, tvecs = (t.cuda() for t in stack_tables(costs, Kp))
    W = 8
    N = -(-n // W)
    lens = np.zeros((N, W), np.int64)
    lens.reshape(-1)[:n] = L
    b = window_batch(rng, lens, "cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    pidx = torch.tensor(np.arange(N) % 2, **i32)
    mixed = torch.tensor((np.arange(N)[:, None] + np.arange(W)) % 2, **i32)
    # the chain forms: one entry a slot (C = 1), xtrans rows from a LUT of
    # the windows' own rows
    chain = dict(wlen=b["lengths"].reshape(N, W, 1).contiguous(),
                 gst=b["starts"].reshape(N, W, 1).contiguous(),
                 xti=torch.arange(N * W, **i32).reshape(N, W, 1),
                 lut=b["xts"].reshape(N * W, 16).contiguous())
    carry = dict(conts=torch.zeros((N, W), **i32),
                 cbig=torch.zeros((N, 13, CW, Kp), device="cuda"),
                 csml=torch.zeros((N, 32, CW, 1), device="cuda"))
    grid = dict(xts=b["xts"].reshape(-1, 16)[:n].contiguous(),
                lens=b["lengths"].reshape(-1)[:n].contiguous(),
                starts=b["starts"].reshape(-1)[:n].contiguous())
    return dict(N=N, W=W, Kp=Kp, L=L, n=n, pidx=pidx, mixed=mixed,
                tables=tables, tvecs=tvecs, xts=b["xts"], lens=b["lengths"],
                starts=b["starts"], codes=b["codes_all"], chain=chain,
                carry=carry, grid=grid, K=[float(k) for k in ks],
                T=b["codes_all"].shape[0])


def wide_shape(Kp: int):
    """`cluster_shape(Kp)` at WIDE lanes a CTA."""
    from deciphon_tpu_torch.ops import viterbi as vk

    with mock.patch.dict(vk.CLUSTER_TARGET_W,
                         score=((vk.MAX_LARGE_KP, WIDE),)):
        return vk.cluster_shape(Kp)


def launcher(torch, lib, kernel: str, a: dict, shape):
    """A call of `kernel` on `lib` in launch shape `shape` (None: an entry
    point that takes none), writing fresh outputs; returns (call, outputs,
    resident clusters)."""
    N, W, Kp, T = a["N"], a["W"], a["Kp"], a["T"]
    tabs = [a["tables"], a["tvecs"]]
    if kernel == "B9":
        g = a["grid"]
        alt = torch.empty((2, a["n"]), device="cuda")
        nul = torch.empty_like(alt)
        args = tabs + [g["xts"], g["lens"], g["starts"], a["codes"], alt,
                       nul, 2, a["n"], Kp, T]
    else:
        alt = torch.empty((N, W), device="cuda")
        nul = torch.empty_like(alt)
    if kernel in ("B1", "B5"):
        pidx = a["mixed"] if kernel == "B5" else a["pidx"]
        args = [pidx, *tabs, a["xts"], a["lens"], a["starts"], a["codes"],
                alt, nul, N, W, Kp, T]
    outs = [alt, nul]
    if kernel in ("B3", "B8"):
        c = a["chain"]
        args = [a["pidx"], *tabs, c["wlen"], c["gst"], c["xti"], c["lut"],
                a["codes"]]
        if kernel == "B8":
            big = torch.empty_like(a["carry"]["cbig"])
            sml = torch.empty_like(a["carry"]["csml"])
            args += [a["carry"]["conts"], a["carry"]["cbig"],
                     a["carry"]["csml"], big, sml]
            outs += [big, sml]
        args += [alt, nul, N, W, 1, Kp, T]
    fn = getattr(lib, FN[kernel])
    vals = [x.data_ptr() if hasattr(x, "data_ptr") else x for x in args]
    stream = torch.cuda.current_stream().cuda_stream
    active = ctypes.c_int(0)
    extra = [] if shape is None else [*shape, ctypes.byref(active)]

    def call():
        err = fn(*vals, *extra, stream)
        if err:
            raise RuntimeError(f"{FN[kernel]} Kp={Kp}: CUDA error {err}")
    return call, outs, active


def bound_ms(kernel: str, a: dict) -> tuple[float, str]:
    """The least time for the call's work: 34 operations a true cell over
    the f32 peak, or its bytes over the memory rate."""
    n, L, Kp, W, N, ks = a["n"], a["L"], a["Kp"], a["W"], a["N"], a["K"]
    # window i is slot i % W of pair i // W
    if kernel == "B9":
        per = [ks[0] + ks[1]] * n
    elif kernel == "B5":
        per = [ks[(i // W + i % W) % 2] for i in range(n)]
    else:
        per = [ks[(i // W) % 2] for i in range(n)]
    cells = L * sum(per)
    byts = 2 * (1364 + 8) * Kp * 4 + n * L * 20 + N * W * (16 + 3) * 4
    byts += (2 * n if kernel == "B9" else N * W) * 8
    if kernel == "B8":
        byts += 2 * N * (13 * 8 * Kp + 32 * 8) * 4
    t_ops, t_b = CELL_OPS * cells / PEAK_F32_OPS, byts / PEAK_BYTES
    return max(t_ops, t_b) * 1e3, ("operations" if t_ops >= t_b else "bytes")


def ms(torch, call) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(REPS):
        call()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit(f"usage: {sys.argv[0]} PARENT_CHECKOUT")
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times kernels on the card")
    sys.path.insert(0, HERE)
    from deciphon_tpu_torch.ops.viterbi import cluster_shape

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = {"change": load_build(HERE, "build_change"),
            "parent": load_build(os.path.abspath(sys.argv[1]),
                                 "build_parent")}
    bad = []
    for Kp in KPS:
        shapes = {"change": cluster_shape(Kp), "wide": wide_shape(Kp)}
        for grid, n, L in GRIDS:
            a = inputs(torch, Kp, n, L, seed=Kp + n)
            for kernel in FN:
                if kernel == "B8":
                    # every slot continues a segment: its carry-in is the
                    # state a fresh call exported at its last position
                    call, outs, _ = launcher(torch, libs["change"], kernel,
                                             a, shapes["change"])
                    call()
                    a["carry"] = dict(
                        conts=torch.ones_like(a["carry"]["conts"]),
                        cbig=outs[2], csml=outs[3])
                calls = {
                    "parent": launcher(torch, libs["parent"], kernel, a,
                                       shapes["wide"] if kernel == "B9"
                                       else None),
                    "change": launcher(torch, libs["change"], kernel, a,
                                       shapes["change"]),
                    "wide": launcher(torch, libs["change"], kernel, a,
                                     shapes["wide"])}
                for call, _, _ in calls.values():
                    call()
                torch.cuda.synchronize()
                po = calls["parent"][1]
                equal = all(torch.equal(x, y) for c in ("change", "wide")
                            for x, y in zip(po, calls[c][1]))
                times = {"parent": [], "change": [], "wide": []}
                for who in ("parent", "change", "change", "parent", "wide",
                            "wide"):
                    times[who].append(ms(torch, calls[who][0]))
                b_ms, b_by = bound_ms(kernel, a)
                row = dict(kernel=kernel, Kp=Kp, grid=grid, windows=n,
                           positions=L, bit_equal=equal, card=smi,
                           **{f"{who}_ms": t for who, t in times.items()},
                           **{f"{who}_us_per_position": [x * 1e3 / L
                                                         for x in t]
                              for who, t in times.items()},
                           speedup=min(times["parent"]) / min(times["change"]),
                           shape=list(shapes["change"]),
                           wide_shape=list(shapes["wide"]),
                           clusters_resident=calls["change"][2].value,
                           wide_clusters_resident=calls["wide"][2].value,
                           bound_ms=b_ms, bound_by=b_by)
                print(json.dumps(row), flush=True)
                if not equal:
                    bad.append((kernel, Kp, grid))
            del a
            torch.cuda.empty_cache()
    if bad:
        sys.exit(f"outputs differ between the builds: {bad}")


if __name__ == "__main__":
    main()
