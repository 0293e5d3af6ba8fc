"""The launch shapes of the lane-packed kernels (B6, B7), held on the CPU:
`ops/viterbi.py` `packed_shape` on every plane the class formation can
make (Kp a multiple of 128 up to PACK_MAX_KP, segments of a multiple of
64 lanes).  The CUDA launchers check the same rules and refuse a shape
that breaks one; these tests keep the function that picks the shapes
inside them."""

import pytest

from deciphon_tpu_torch.ops import viterbi as vk

PLANES = [(Kp, nseg) for Kp in range(128, vk.PACK_MAX_KP + 1, 128)
          for nseg in range(1, Kp // vk.PACK_SEG_QUANTUM + 1)
          if Kp % nseg == 0 and (Kp // nseg) % vk.PACK_SEG_QUANTUM == 0]


def test_planes_cover_the_pfam_classes():
    # the Pfam scan's classes (seg, nseg): (1024, 2), (448, 2), (192, 6)
    # and (64, 2)
    for seg, nseg in ((1024, 2), (448, 2), (192, 6), (64, 2), (64, 32)):
        assert (seg * nseg, nseg) in PLANES


def test_threads_are_whole_warps_of_the_plane():
    for Kp, nseg in PLANES:
        s = vk.packed_shape(Kp, nseg)
        assert s.lpt in (2, 4), (Kp, nseg, s)
        assert s.threads * s.lpt == Kp, (Kp, nseg, s)
        assert s.threads % 32 == 0 and 0 < s.threads <= 1024, (Kp, nseg, s)
        assert s.threads <= vk.MAX_THREADS, (Kp, nseg, s)


def test_segments_are_whole_thread_groups():
    """A segment is a whole number of 16-thread groups (of warps at LPT
    2), so that no thread straddles two and the group minima of E belong
    to one segment each."""
    for Kp, nseg in PLANES:
        s = vk.packed_shape(Kp, nseg)
        tps = Kp // nseg // s.lpt
        assert tps * s.lpt * nseg == Kp, (Kp, nseg, s)
        assert tps % (32 if s.lpt == 2 else 16) == 0, (Kp, nseg, s)
        assert s.threads // 16 <= 32, (Kp, nseg, s)  # E's groups: one warp


def test_specials_fit_one_warp():
    """Lane s of warp 0 owns segment s's special states."""
    for Kp, nseg in PLANES:
        s = vk.packed_shape(Kp, nseg)
        assert s.threads // (Kp // nseg // s.lpt) == nseg <= 32, (Kp, nseg)


def test_shared_bytes_fit_a_cta():
    for Kp, nseg in PLANES:
        s = vk.packed_shape(Kp, nseg)
        assert s.smem == vk.PACKED_PLANES * Kp * 4, (Kp, nseg, s)
        assert s.smem + vk.PACKED_STATIC_BYTES <= vk.SMEM_BYTES == 232_448


def test_lane_band():
    """LPT 2 up to PACK_LPT2_MAX_KP, 4 beyond, whatever the segments."""
    for Kp, nseg in PLANES:
        lpt = 2 if Kp <= vk.PACK_LPT2_MAX_KP else 4
        assert vk.packed_shape(Kp, nseg).lpt == lpt, (Kp, nseg)


@pytest.mark.parametrize("Kp,nseg", [(128, 3), (256, 8), (2176, 2),
                                     (192, 1), (640, 0), (4096, 32)])
def test_other_planes_raise(Kp, nseg):
    with pytest.raises(NotImplementedError):
        vk.packed_shape(Kp, nseg)
