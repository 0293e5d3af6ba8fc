"""The dense-grid kernel's (B9's) launch, held on the CPU: `scores_grid`
launches the score body of B1 and B4 in B4's launch shape,
`cluster_shape(Kp, "score")`, at every lane width it takes (every multiple
of 128 up to MAX_LARGE_KP): one CTA a window up to Kp 2048, a thread-block
cluster past it, no global scratch at any width.  The CUDA launcher checks
the same rules and refuses a shape that breaks one; these tests keep the
wrapper on them.  On CPU tensors the wrapper runs the plain version."""

import numpy as np
import pytest
import torch

from deciphon_tpu_torch import _build
from deciphon_tpu_torch.frame import TABLE_SIZE
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.ops.costs import build_costs
from deciphon_tpu_torch.ops.tables import stack_tables
from deciphon_tpu_torch.profile import sample_profile
from deciphon_tpu_torch.workload import window_batch

KPS = range(128, vk.MAX_LARGE_KP + 1, 128)


def grid_args(Kp, P=1, B=2, T=4):
    """B9's inputs at lane width Kp; the tables are left unfilled (only
    the launch is looked at)."""
    return dict(tables=torch.empty((P, TABLE_SIZE, Kp)),
                tvecs=torch.empty((P, 8, Kp)),
                xts=torch.zeros((B, 16)),
                lengths=torch.ones((B,), dtype=torch.int32),
                starts=torch.zeros((B,), dtype=torch.int32),
                codes_all=torch.zeros((T, 5), dtype=torch.int32))


@pytest.fixture
def launched(monkeypatch):
    """The launches `scores_grid` would make on a card: (entry point,
    LAUNCHES key, Kp, shape, arguments before the shape)."""
    calls = []
    monkeypatch.setattr(vk, "on_cuda", lambda *tensors: True)
    monkeypatch.setattr(vk, "_launch_shaped",
                        lambda fn, key, Kp, shape, *args:
                        calls.append((fn, key, Kp, shape, args)))
    return calls


def test_grid_launches_b4s_shape_at_every_width(launched):
    for Kp in KPS:
        vk.scores_grid(**grid_args(Kp))
    assert [c[2] for c in launched] == list(KPS)
    for fn, key, Kp, shape, _ in launched:
        assert (fn, key) == ("dtt_score_grid", "grid")
        assert shape == vk.cluster_shape(Kp, "score"), Kp


def test_grid_one_cta_up_to_2048_clusters_past_it(launched):
    for Kp in KPS:
        vk.scores_grid(**grid_args(Kp))
    for _, _, Kp, s, _ in launched:
        assert (s.c == 1) == (Kp <= vk.FAST_MAX_KP), (Kp, s)
        if s.c == 1:  # the score body's band: 2 lanes a thread up to 512
            assert (s.w, s.lpt) == (Kp, 2 if Kp <= 512 else 4), (Kp, s)
        else:
            assert s.lpt == 4 and s.c <= vk.MAX_CLUSTER, (Kp, s)
        # the DP state lives in shared memory at every width
        assert s.smem == vk.SCORE_PLANES * s.w * 4 <= vk.SMEM_BYTES, (Kp, s)


def test_grid_launch_arguments(launched):
    """Inputs in place, (P, B) outputs, then P, B, Kp and the code rows:
    no scratch tensor is passed or allocated."""
    a = grid_args(5632, P=3, B=5, T=7)
    alt, nul = vk.scores_grid(**a)
    (_, _, _, _, args), = launched
    names = ("tables", "tvecs", "xts", "lengths", "starts", "codes_all")
    assert all(x is a[n] for x, n in zip(args, names))
    assert args[6] is alt and args[7] is nul
    assert alt.shape == nul.shape == (3, 5)
    assert args[8:] == (3, 5, 5632, 7)
    # the C signature: 8 pointers, P B Kp T and the shape, int*, stream
    assert len(_build.SIGNATURES["dtt_score_grid"]) == 8 + 4 + 5 + 2


@pytest.mark.parametrize("P,max_p", [(0, 3), (1, 3), (3, 3), (8, 3),
                                     (65535, 65535), (65536, 65535),
                                     (200_000, 65535)])
def test_grid_chunks_cover_the_profiles_in_order(P, max_p):
    chunks = vk.grid_chunks(P, max_p)
    assert [lo for lo, _ in chunks] == list(range(0, P, max_p))
    assert all(0 < hi - lo <= max_p for lo, hi in chunks)
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert (chunks[-1][1] if chunks else 0) == P
    assert len(chunks) == -(-P // max_p)


def test_grid_launches_in_chunks_of_profiles(launched, monkeypatch):
    """Past GRID_MAX_P profiles (the card's gridDim.y limit, lowered here
    to 3) B9 launches once per chunk, each on its contiguous rows of the
    tables and of the (P, B) outputs."""
    assert vk.GRID_MAX_P == 65535
    monkeypatch.setattr(vk, "GRID_MAX_P", 3)
    a = grid_args(128, P=8, B=5, T=7)
    alt, nul = vk.scores_grid(**a)
    assert [c[4][8] for c in launched] == [3, 3, 2]  # P of each launch
    for (fn, key, Kp, shape, args), lo in zip(launched, (0, 3, 6)):
        hi = min(lo + 3, 8)
        assert (fn, key, Kp) == ("dtt_score_grid", "grid", 128)
        assert shape == vk.cluster_shape(128, "score")
        assert args[0].shape == (hi - lo, *a["tables"].shape[1:])
        assert args[0].data_ptr() == a["tables"][lo].data_ptr()
        assert args[1].data_ptr() == a["tvecs"][lo].data_ptr()
        assert all(x is a[n] for x, n in zip(args[2:6], (
            "xts", "lengths", "starts", "codes_all")))
        assert args[6].data_ptr() == alt[lo].data_ptr()
        assert args[7].data_ptr() == nul[lo].data_ptr()
        assert args[6].is_contiguous() and args[6].shape == (hi - lo, 5)
        assert args[9:] == (5, 128, 7)


def test_grid_scratch_constants_are_gone():
    assert not hasattr(vk, "GRID_SMEM_BYTES")
    assert not hasattr(vk, "GRID_PLANES")


@pytest.mark.parametrize("Kp", [128, 2176])
def test_grid_on_cpu_is_the_plain_version(Kp):
    costs = [build_costs(sample_profile(70 + i, k))
             for i, k in enumerate((Kp - 2, 9))]
    tables, tvecs = stack_tables(costs, Kp)
    lens = np.array([[23, 1, 0, 31]], np.int32)
    batch = window_batch(np.random.default_rng(Kp), lens)
    g = dict(tables=tables, tvecs=tvecs, xts=batch["xts"][0].contiguous(),
             lengths=batch["lengths"][0, :, 0].contiguous(),
             starts=batch["starts"][0].contiguous(),
             codes_all=batch["codes_all"])
    before = dict(vk.LAUNCHES)
    alt, nul = vk.scores_grid(**g)
    assert vk.LAUNCHES == before  # CPU tensors: no kernel
    pa, pn = vk.scores_grid_plain(**g)
    assert torch.equal(alt, pa) and torch.equal(nul, pn)
    assert torch.isinf(alt[:, 2]).all() and torch.isfinite(alt[:, 1]).all()
