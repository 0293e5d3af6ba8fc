"""The launch shapes of the clustered kernels (the score family B1, B3,
B5, B8, B4, B4m, B9, and B2), held on the CPU: `ops/viterbi.py`
`cluster_shape` for every lane width the large-K tier takes (every
multiple of 128 up to MAX_LARGE_KP).  The CUDA launchers
check the same rules and refuse a shape that breaks one; these tests keep
the function that picks the shapes inside them."""

import pytest

from deciphon_tpu_torch.ops import viterbi as vk

KPS = range(128, vk.MAX_LARGE_KP + 1, 128)
BODIES = ["score", "path"]


@pytest.mark.parametrize("body", BODIES)
def test_ranks_cover_every_lane_once(body):
    for Kp in KPS:
        s = vk.cluster_shape(Kp, body)
        ranges = [(r * s.w, min((r + 1) * s.w, Kp)) for r in range(s.c)]
        assert all(lo < hi for lo, hi in ranges), (Kp, s)  # no empty rank
        assert ranges[0][0] == 0 and ranges[-1][1] == Kp, (Kp, s)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("body", BODIES)
def test_threads_lanes_and_warps(body):
    for Kp in KPS:
        s = vk.cluster_shape(Kp, body)
        # csrc: B2's clustered instance is bounded at 384 threads
        most = 384 if body == "path" and s.c > 1 else vk.MAX_THREADS
        assert s.threads % 32 == 0 and 0 < s.threads <= most, (Kp, s)
        assert s.threads * s.lpt == s.w, (Kp, s)
        # whole warps: only the last rank has dead ones, and they are dead
        # in every lane
        assert s.w % (32 * s.lpt) == 0 and Kp % (32 * s.lpt) == 0, (Kp, s)


@pytest.mark.parametrize("body", BODIES)
def test_shared_bytes_fit_a_cta(body):
    planes = vk.SCORE_PLANES if body == "score" else vk.PATH_PLANES
    for Kp in KPS:
        s = vk.cluster_shape(Kp, body)
        assert s.smem == planes * s.w * 4
        assert s.smem <= vk.SMEM_BYTES == 232_448, (Kp, s)


@pytest.mark.parametrize("body", BODIES)
def test_cluster_sizes(body):
    for Kp in KPS:
        s = vk.cluster_shape(Kp, body)
        assert 1 <= s.c <= vk.MAX_CLUSTER == 16, (Kp, s)
        assert (s.c == 1) == (Kp <= 2048), (Kp, s)
        if s.c > 1:
            assert s.lpt == 4, (Kp, s)
    assert vk.cluster_shape(vk.MAX_LARGE_KP, body).c > 1


@pytest.mark.parametrize("body", BODIES)
def test_single_cta_bands_unchanged(body):
    """Up to Kp 2048 a window is one CTA with the redesigned bodies' lane
    bands: the score body 2 lanes a thread up to Kp 512 (the launchers'
    `shape_ok`), B2 up to Kp 1024, 4 beyond."""
    edge = 512 if body == "score" else 1024
    for Kp in KPS:
        if Kp > 2048:
            break
        s = vk.cluster_shape(Kp, body)
        assert (s.c, s.w, s.lpt) == (1, Kp, 2 if Kp <= edge else 4), (Kp, s)


def test_unknown_body_raises():
    with pytest.raises(ValueError):
        vk.cluster_shape(4096, "grid")
