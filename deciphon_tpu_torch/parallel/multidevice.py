"""Device-parallel scan scoring: the pair dim of every phase-1 wave split
over a list of devices.

Counterpart of deciphon_tpu/parallel/multidevice.py, which runs each wave
as one SPMD program over a 1D `jax.sharding.Mesh`.  Torch has no mesh, so
`make_mesh` returns the ordered tuple of torch devices, and a device may
repeat: two shards on one card is how a one-card machine runs this path.
The subclasses override what the reference's override, with the same
contract:

  * tables are replicated once on each distinct device (the large-K tier
    holds them on the first device alone); a streamed scorer uploads them
    per wave to each distinct device, each on that device's side stream;
  * the scan's code table and the xtrans LUT are copied once to each
    distinct device and shared by sibling scorers (DeviceSeqCodes.on);
  * each phase-1 call (B1, B3, the gang B5 or B4m, B8, B6, B7) pads its
    pair (or pack-group) dim to a multiple of the shard count (pad rows
    have length 0, pad starts point past every real row), splits it into
    contiguous equal shards and launches each shard on its device, on a
    stream of its own, with the kernels of the one-device path; the
    outputs come back as scheduler.ShardedPlane, which the scheduler
    fetches once a device after each shard's event;
  * the carry tier (B8) routes the previous chunk's carry planes to the
    destination shards from whichever shards hold them, on the devices
    (a peer copy between distinct cards), never through the host;
  * the large-K tier (B4) and phase 2 (B2 and the walk) run on the first
    device: LRT survivors are a sliver of the windows;
  * under DECIPHON_SYNC_DEBUG the scheduler's dispatch records one bucket
    ledger entry a sharded launch, under the one-device name (its group
    count is the wave's, before the padding to the shards) with the
    one-device cells, its wall taken once every shard's event has
    passed (`fetch_planes`).

Products are therefore byte-identical to a one-device scan for any shard
count (the reference's thread-count-invariance contract).  No collective
is needed: pairs are independent.  A shard that cannot launch raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import viterbi as vk
from ..ops.costs import ViterbiCosts
from ..scan.scheduler import (PackedPairScorer, PairScorer, ShardedPlane,
                              _tensors, canonical_device)

__all__ = ["MESH_AXIS", "MultiDevicePairScorer", "MultiDevicePackedScorer",
           "make_mesh", "SHARD_LAUNCHES", "ROUTED", "reset_shard_launches"]

# The reference's name for its mesh's one axis: here, the dim that a wave's
# pairs are split along.
MESH_AXIS = "dev"

# Kernel launches by shard index and LAUNCHES key: the differences of the
# wrappers' own counts (ops/viterbi.py LAUNCHES) around each shard's launch.
SHARD_LAUNCHES: dict[int, dict[str, int]] = {}
# Carry rows routed between consecutive segment chunks (B8), and those of
# them whose source row lies in another shard.
ROUTED = {"rows": 0, "cross": 0}

# (shard index, device) -> the shard's stream, shared by every scorer
_SHARD_STREAMS: dict[tuple[int, torch.device], torch.cuda.Stream] = {}


def reset_shard_launches() -> None:
    SHARD_LAUNCHES.clear()
    ROUTED["rows"] = ROUTED["cross"] = 0


def make_mesh(devices=None) -> tuple[torch.device, ...]:
    """The shards' devices, in order, each with its index; every visible
    card by default.  A device may repeat.  A CUDA device without a card
    raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): no CUDA device is available")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh(): device {d} but no CUDA device "
                               "is available")
        mesh.append(canonical_device(d))
    if not mesh:
        raise ValueError("make_mesh(): no device given")
    return tuple(mesh)


def _stream(i: int, dev: torch.device) -> torch.cuda.Stream:
    s = _SHARD_STREAMS.get((i, dev))
    if s is None:
        s = _SHARD_STREAMS[(i, dev)] = torch.cuda.Stream(dev)
    return s


@contextlib.contextmanager
def _on_shard(i: int, dev: torch.device):
    """Shard i's device and stream (which first waits for the device's
    current stream: tables, codes and LUT come from there); None on the
    CPU."""
    if dev.type != "cuda":
        yield None
        return
    s = _stream(i, dev)
    with torch.cuda.device(dev):
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            yield s


class _Sharded:
    """Replicated tables, codes and LUT, and sharded launches, over
    `mesh`; mixed into the scheduler's kernel scorers."""

    def _init_mesh(self, mesh) -> None:
        self.mesh = tuple(mesh)
        self.ndev = len(self.mesh)
        self.distinct = list(dict.fromkeys(self.mesh))
        self._replicas: dict[torch.device, tuple] = {}
        self._luts: dict[torch.device, torch.Tensor] = {}
        self._lut_src = None

    # -- placement ------------------------------------------------------

    def _place_tables(self) -> tuple:
        devs = (self.distinct[:1] if getattr(self, "hbm_table", False)
                else self.distinct)
        self._replicas = {d: self._place_on(d) for d in devs}
        return self._replicas[self.distinct[0]]

    def _replica(self, dev: torch.device) -> tuple:
        if self._tables_cache is None:
            self._tables_cache = self._place_tables()
        return self._replicas.get(dev, ())

    def release_tables(self) -> None:
        super().release_tables()
        if self.stream_tables:
            self._replicas = {}

    def set_streaming(self, on: bool) -> None:
        super().set_streaming(on)
        self._replicas = {}

    def _lut_on(self, dev: torch.device) -> torch.Tensor:
        """The xtrans LUT on `dev`, copied once a device from the first
        device's upload (`_xt_lut_dev`, renewed when the LUT grows)."""
        if self._lut_src is not self._xt_lut_dev:
            self._luts = {}
            self._lut_src = self._xt_lut_dev
        lut = self._luts.get(dev)
        if lut is None:
            lut = self._luts[dev] = self._xt_lut_dev.to(dev)
        return lut

    # -- sharded launches -----------------------------------------------

    def _launch_shards(self, arrays, pads, launch, lut: bool = False
                       ) -> tuple:
        """Pad the leading dim of the host `arrays` to a multiple of the
        shard count (array k's pad rows are pads[k]), split them into
        contiguous equal shards and call launch(i, dev, *tensors) for each
        shard i on its device and stream.  Returns one ShardedPlane per
        output of `launch`.  The tables, the code table and (`lut`) the
        LUT are placed on every distinct device first, on its current
        stream, for which each shard's stream then waits."""
        for dev in self.distinct:
            self._replica(dev)
            self.dev_codes.on(dev)
            if lut:
                self._lut_on(dev)
        n = arrays[0].shape[0]
        ns = -(-n // self.ndev)
        if ns * self.ndev > n:
            arrays = [np.concatenate(
                [a, np.full((ns * self.ndev - n,) + a.shape[1:], pad,
                            a.dtype)]) for a, pad in zip(arrays, pads)]
        outs, events = [], []
        for i, dev in enumerate(self.mesh):
            before = dict(vk.LAUNCHES)
            with _on_shard(i, dev) as s:
                out = launch(i, dev, *_tensors(
                    dev, *(a[i * ns:(i + 1) * ns] for a in arrays)))
                ev = None
                if s is not None:
                    # the shared inputs stay allocated until the shard's
                    # stream is done with them
                    for t in self._shared(dev):
                        t.record_stream(s)
                    ev = torch.cuda.Event()
                    ev.record(s)
            per = SHARD_LAUNCHES.setdefault(i, {})
            for k, v in vk.LAUNCHES.items():
                if v != before[k]:
                    per[k] = per.get(k, 0) + v - before[k]
            outs.append(out)
            events.append(ev)
        return tuple(ShardedPlane([o[k] for o in outs], events)
                     for k in range(len(outs[0])))

    def _shared(self, dev: torch.device) -> list:
        held = list(self._replicas.get(dev, ()))
        if self.dev_codes is not None:
            held.append(self.dev_codes.on(dev))
        if dev in self._luts:
            held.append(self._luts[dev])
        return held


class MultiDevicePairScorer(_Sharded, PairScorer):
    """PairScorer whose phase-1 waves are split over the shards of
    `mesh` (or `make_mesh(devices)`); the large-K tier (`hbm_table`) and
    phase 2 run on the first device."""

    def __init__(self, costs_list: list[ViterbiCosts], devices=None,
                 mesh=None, w: int = 8, hbm_table: bool = False):
        self._init_mesh(make_mesh(devices if mesh is None else mesh))
        super().__init__(costs_list, self.mesh[0], w=w, hbm_table=hbm_table)

    def _invoke_scores_from_starts(self, pidx, xts, lens, starts):
        if self.hbm_table:  # B4 on the first device
            return super()._invoke_scores_from_starts(pidx, xts, lens,
                                                      starts)

        def launch(i, dev, pidx, xts, lens, starts):
            tables, tvecs = self._replica(dev)
            return vk.scores_pairs(pidx, tables, tvecs, xts, lens, starts,
                                   self.dev_codes.on(dev))

        return self._launch_shards([pidx, xts, lens, starts],
                                   [0, 0, 0, self.dev_codes.pad_start],
                                   launch)

    def _invoke_scores_chained(self, pidx, sblk, wlen, gst, xti):
        def launch(i, dev, pidx, sblk, wlen, gst, xti):
            tables, tvecs = self._replica(dev)
            return vk.scores_pairs_chained(pidx, tables, tvecs, sblk, wlen,
                                           gst, xti, self._lut_on(dev),
                                           self.dev_codes.on(dev))

        return self._launch_shards([pidx, sblk, wlen, gst, xti],
                                   [0, 0, 0, self.dev_codes.pad_start, 0],
                                   launch, lut=True)

    def _invoke_scores_gang(self, pidx, xts, lens, starts):
        resident = self._gang_resident()

        def launch(i, dev, pidx, xts, lens, starts):
            tables, tvecs = self._replica(dev)
            fn = (vk.scores_pairs_mixed if resident
                  else vk.scores_pairs_mixed_large)
            return fn(pidx, tables, tvecs, xts, lens, starts,
                      self.dev_codes.on(dev))

        return self._launch_shards([pidx, xts, lens, starts],
                                   [0, 0, 0, self.dev_codes.pad_start],
                                   launch)

    def _invoke_scores_chained_carry(self, pidx, sblk, wlen, gst, xti,
                                     conts, route, carry_prev):
        """B8 on every shard.  Shard i owns pairs [i * ns, (i + 1) * ns) of
        the padded chunk; its carry-in rows come from the previous
        chunk's shards that hold the routed slots (`_routed`)."""
        CW = vk.CW
        n = pidx.shape[0]
        ns = -(-n // self.ndev)
        N = ns * self.ndev
        # the slots that continue a window: only those read their carry
        flags = np.zeros((N, CW), bool)
        k = min(conts.shape[1], CW)
        flags[:n, :k] = conts[:, :k] > 0
        route = np.pad(route, (0, (N - n) * CW))

        def launch(i, dev, pidx, sblk, wlen, gst, xti, conts):
            if carry_prev is None:
                cbig = torch.zeros((ns, 13, CW, self.Kp), device=dev)
                csml = torch.zeros((ns, 32, CW, 1), device=dev)
            else:
                cbig, csml = self._routed(i, dev, carry_prev,
                                          route[i * ns * CW:(i + 1) * ns * CW],
                                          flags[i * ns:(i + 1) * ns])
            tables, tvecs = self._replica(dev)
            return vk.scores_pairs_chained_carry(
                pidx, tables, tvecs, sblk, wlen, gst, xti, conts, cbig,
                csml, self._lut_on(dev), self.dev_codes.on(dev))

        alt, nul, cbig, csml = self._launch_shards(
            [pidx, sblk, wlen, gst, xti, conts],
            [0, 0, 0, self.dev_codes.pad_start, 0, 0], launch, lut=True)
        return alt, nul, cbig, csml

    def _routed(self, i: int, dev: torch.device, carry_prev, route,
                flags) -> tuple:
        """Carry-in planes of shard i ((ns, 13, CW, Kp), (ns, 32, CW, 1)):
        slot (n, w) that continues a window takes flat slot route[n * CW +
        w] = n' * CW + w' of the previous chunk, which shard n' // ns' of
        it holds; other slots stay 0 (the kernel does not read them).
        Each source shard gathers its rows on its own device and stream;
        rows of another card cross as one peer copy."""
        CW = vk.CW
        pbig, psml = carry_prev
        ns_src = pbig.parts[0].shape[0]
        ns = flags.shape[0]
        big = torch.zeros((ns, 13, CW, self.Kp), device=dev)
        sml = torch.zeros((ns, 32, CW, 1), device=dev)
        dst = np.nonzero(flags.reshape(-1))[0]
        if not len(dst):
            return big, sml
        src = route[dst].astype(np.int64)
        shard, local = src // (ns_src * CW), src % (ns_src * CW)
        ROUTED["rows"] += len(dst)
        ROUTED["cross"] += int((shard != i).sum())
        for j in np.unique(shard).tolist():
            m = shard == j
            sdev = self.mesh[j]
            src_ctx = (torch.cuda.stream(_stream(j, sdev))
                       if sdev.type == "cuda" else contextlib.nullcontext())
            with src_ctx:
                idx = torch.from_numpy(local[m]).to(sdev)
                nsrc, wsrc = idx // CW, idx % CW
                gb = pbig.parts[j][nsrc, :, wsrc]  # (len, 13, Kp)
                gs = psml.parts[j][nsrc, :, wsrc]  # (len, 32, 1)
                if sdev != dev:  # a peer copy, ordered on both streams
                    gb, gs = gb.to(dev), gs.to(dev)
            if sdev == dev and dev.type == "cuda":
                s = torch.cuda.current_stream(dev)
                s.wait_stream(_stream(j, sdev))
                gb.record_stream(s)
                gs.record_stream(s)
            d = torch.from_numpy(dst[m]).to(dev)
            big[d // CW, :, d % CW] = gb
            sml[d // CW, :, d % CW] = gs
        return big, sml


class MultiDevicePackedScorer(_Sharded, PackedPairScorer):
    """Lane-packed small-K scorer whose phase-1 waves are split over the
    shards (the pack-group dim); its inner unpacked scorer (multi-window
    reads, phase 2) is a MultiDevicePairScorer over the same mesh."""

    def __init__(self, costs_list: list[ViterbiCosts], nseg: int, mesh=None,
                 devices=None, inner_w: int | None = None,
                 seg: int | None = None):
        self._init_mesh(make_mesh(devices if mesh is None else mesh))
        mesh = self.mesh
        super().__init__(
            costs_list, nseg, mesh[0], inner_w=inner_w, seg=seg,
            inner_factory=lambda costs, device, w: MultiDevicePairScorer(
                costs, mesh=mesh, w=w))

    def _invoke_scores_packed(self, pidx, xts, lens, starts):
        def launch(i, dev, pidx, xts, lens, starts):
            tables, tvecs = self._replica(dev)
            return vk.scores_pairs_packed(pidx, tables, tvecs, xts, lens,
                                          starts, self.dev_codes.on(dev),
                                          nseg=self.nseg)

        return self._launch_shards([pidx, xts, lens, starts],
                                   [0, 0, 0, self.dev_codes.pad_start],
                                   launch)

    def _invoke_scores_packed_chained(self, pidx, sblk, wlen, gst, xti):
        def launch(i, dev, pidx, sblk, wlen, gst, xti):
            tables, tvecs = self._replica(dev)
            N, Wc, C = sblk.shape

            def per_seg(a):
                return a[:, :, None, :].expand(N, Wc, self.nseg,
                                               C).contiguous()

            return vk.scores_pairs_packed_chained(
                pidx, tables, tvecs, sblk, wlen, gst, per_seg(sblk),
                per_seg(wlen), per_seg(xti), self._lut_on(dev),
                self.dev_codes.on(dev), nseg=self.nseg)

        return self._launch_shards([pidx, sblk, wlen, gst, xti],
                                   [0, 0, 0, self.dev_codes.pad_start, 0],
                                   launch, lut=True)
