"""hmmpgmd binary reply codec (the h3client wire format).

The reference's confirmation stage talks to HMMER3's hmmpgmd daemon
through the h3client C library (c-core/hmmer.c:83-108 h3c_socket_send/
recv).  The daemon's reply is HMMER's own serialization (HMMER
src/hmmpgmd + p7_hit/p7_domain/p7_alidisplay Serialize functions), which
h3client decodes into the h3result structures that the reference stores
as `.h3r` blobs.  This module implements both directions of that binary
format so the TCP client (hmmer/client.py) can decode a genuine daemon's
reply into an `H3Result`, and the in-repo fake daemon (hmmer/daemon.py)
emits the same bytes for CI.

All integers are big-endian (network order); doubles/floats are IEEE754
bit patterns carried in u64/u32.

Reply layout (after the 12-byte HMMD_SEARCH_STATUS handled in client.py):

  stats :=
    elapsed f64 | user f64 | sys f64 | Z f64 | domZ f64 |
    Z_setby u8 | domZ_setby u8 |
    nmodels u64 | nseqs u64 | n_past_msv u64 | n_past_bias u64 |
    n_past_vit u64 | n_past_fwd u64 | nhits u64 | nreported u64 |
    nincluded u64 |
    hit_offsets: u64 == 0xFFFF..FF when absent, else nhits u64s
    (first one already read)

  hit :=
    size u32 (bytes of this hit record, incl. this field) |
    window_length u32 |
    sortkey f64 | score f32 | pre_score f32 | sum_score f32 |
    lnP f64 | pre_lnP f64 | sum_lnP f64 | nexpected f32 |
    nregions u32 | nclustered u32 | noverlaps u32 | nenvelopes u32 |
    ndom u32 | flags u32 | nreported u32 | nincluded u32 |
    best_domain u32 | seqidx u64 | subseq_start u64 |
    presence u8 (bit0 name, bit1 acc, bit2 desc) |
    name\\0 [acc\\0] [desc\\0] |
    ndom × domain

  domain :=
    size u32 | ienv u64 | jenv u64 | iali u64 | jali u64 |
    envsc f32 | domcorrection f32 | dombias f32 | oasc f32 |
    bitscore f32 | lnP f64 | is_reported u32 | is_included u32 |
    scale_per_pos: u32 count, count × f32 |
    alidisplay

  alidisplay :=
    size u32 | N u32 | hmmfrom u32 | hmmto u32 | M u32 |
    sqfrom u64 | sqto u64 | L u64 |
    presence u8 (bit0 rfline, bit1 mmline, bit2 csline, bit3 ppline,
                 bit4 aseq, bit5 ntseq — matches .h3r `presence`) |
    strings, each \\0-terminated, in order:
      [rfline] [mmline] [csline] model mline [aseq] [ntseq] [ppline]
      hmmname hmmacc hmmdesc sqname sqacc sqdesc

Environment note: no HMMER build exists in this image, so the layout is
documented here as the single source of truth and exercised by
round-trip tests plus cross-checks against the reference-produced `.h3r`
fixtures (tests/test_wire.py); the parse entry point stays pluggable in
HMMERClient for live-daemon validation.
"""

from __future__ import annotations

import struct

from .h3result import (
    H3AliDisplay,
    H3Domain,
    H3Hit,
    H3Result,
    H3Stats,
    H3TopHits,
)

__all__ = ["serialize_reply", "parse_reply", "WireError"]

NO_OFFSETS = 0xFFFFFFFFFFFFFFFF

P_RFLINE, P_MMLINE, P_CSLINE, P_PPLINE, P_ASEQ, P_NTSEQ = 1, 2, 4, 8, 16, 32
H_NAME, H_ACC, H_DESC = 1, 2, 4


class WireError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise WireError("truncated hmmpgmd reply")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self.take(8))[0]

    def f32(self) -> float:
        return struct.unpack(">f", self.take(4))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self.take(8))[0]

    def cstr(self) -> str:
        end = self.data.find(b"\0", self.pos)
        if end < 0:
            raise WireError("unterminated string in hmmpgmd reply")
        out = self.data[self.pos:end].decode("utf-8", "replace")
        self.pos = end + 1
        return out


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def u8(self, v: int):
        self.parts.append(struct.pack("B", v & 0xFF))

    def u32(self, v: int):
        self.parts.append(struct.pack(">I", v & 0xFFFFFFFF))

    def u64(self, v: int):
        self.parts.append(struct.pack(">Q", v & NO_OFFSETS))

    def f32(self, v: float):
        self.parts.append(struct.pack(">f", v))

    def f64(self, v: float):
        self.parts.append(struct.pack(">d", v))

    def cstr(self, s: str):
        self.parts.append(s.encode() + b"\0")

    def bytes(self) -> bytes:
        return b"".join(self.parts)


# ---------------------------------------------------------------------------
# alidisplay
# ---------------------------------------------------------------------------


def _write_alidisplay(ad: H3AliDisplay) -> bytes:
    w = _Writer()
    w.u32(ad.N)
    w.u32(ad.hmmfrom)
    w.u32(ad.hmmto)
    w.u32(ad.M)
    w.u64(ad.sqfrom)
    w.u64(ad.sqto)
    w.u64(ad.L)
    presence = ad.presence or H3AliDisplay.presence_of(
        rfline=ad.rfline, mmline=ad.mmline, csline=ad.csline,
        ppline=ad.ppline, aseq=ad.aseq, ntseq=ad.ntseq)
    w.u8(presence)
    if presence & P_RFLINE:
        w.cstr(ad.rfline)
    if presence & P_MMLINE:
        w.cstr(ad.mmline)
    if presence & P_CSLINE:
        w.cstr(ad.csline)
    w.cstr(ad.model)
    w.cstr(ad.mline)
    if presence & P_ASEQ:
        w.cstr(ad.aseq)
    if presence & P_NTSEQ:
        w.cstr(ad.ntseq)
    if presence & P_PPLINE:
        w.cstr(ad.ppline)
    w.cstr(ad.hmmname)
    w.cstr(ad.hmmacc)
    w.cstr(ad.hmmdesc)
    w.cstr(ad.sqname)
    w.cstr(ad.sqacc)
    w.cstr(ad.sqdesc)
    body = w.bytes()
    return struct.pack(">I", len(body) + 4) + body


def _read_alidisplay(r: _Reader) -> H3AliDisplay:
    start = r.pos
    size = r.u32()
    ad = H3AliDisplay()
    ad.N = r.u32()
    ad.hmmfrom = r.u32()
    ad.hmmto = r.u32()
    ad.M = r.u32()
    ad.sqfrom = r.u64()
    ad.sqto = r.u64()
    ad.L = r.u64()
    presence = r.u8()
    ad.presence = presence
    if presence & P_RFLINE:
        ad.rfline = r.cstr()
    if presence & P_MMLINE:
        ad.mmline = r.cstr()
    if presence & P_CSLINE:
        ad.csline = r.cstr()
    ad.model = r.cstr()
    ad.mline = r.cstr()
    if presence & P_ASEQ:
        ad.aseq = r.cstr()
    if presence & P_NTSEQ:
        ad.ntseq = r.cstr()
    if presence & P_PPLINE:
        ad.ppline = r.cstr()
    ad.hmmname = r.cstr()
    ad.hmmacc = r.cstr()
    ad.hmmdesc = r.cstr()
    ad.sqname = r.cstr()
    ad.sqacc = r.cstr()
    ad.sqdesc = r.cstr()
    if r.pos - start != size:
        raise WireError(
            f"alidisplay size mismatch: {r.pos - start} != {size}")
    return ad


# ---------------------------------------------------------------------------
# domain
# ---------------------------------------------------------------------------


def _write_domain(d: H3Domain) -> bytes:
    w = _Writer()
    w.u64(d.ienv)
    w.u64(d.jenv)
    w.u64(d.iali)
    w.u64(d.jali)
    w.f32(d.envsc)
    w.f32(d.domcorrection)
    w.f32(d.dombias)
    w.f32(d.oasc)
    w.f32(d.bitscore)
    w.f64(d.lnP)
    w.u32(1 if d.is_reported else 0)
    w.u32(1 if d.is_included else 0)
    w.u32(len(d.scale_per_pos))
    for v in d.scale_per_pos:
        w.f32(v)
    body = w.bytes() + _write_alidisplay(d.ad)
    return struct.pack(">I", len(body) + 4) + body


def _read_domain(r: _Reader) -> H3Domain:
    start = r.pos
    size = r.u32()
    d = H3Domain()
    d.ienv = r.u64()
    d.jenv = r.u64()
    d.iali = r.u64()
    d.jali = r.u64()
    d.envsc = r.f32()
    d.domcorrection = r.f32()
    d.dombias = r.f32()
    d.oasc = r.f32()
    d.bitscore = r.f32()
    d.lnP = r.f64()
    d.is_reported = bool(r.u32())
    d.is_included = bool(r.u32())
    n = r.u32()
    d.scale_per_pos = [r.f32() for _ in range(n)]
    d.ad = _read_alidisplay(r)
    if r.pos - start != size:
        raise WireError(f"domain size mismatch: {r.pos - start} != {size}")
    return d


# ---------------------------------------------------------------------------
# hit
# ---------------------------------------------------------------------------


def _write_hit(h: H3Hit, window_length: int = 0) -> bytes:
    w = _Writer()
    w.u32(window_length)
    w.f64(h.sortkey)
    w.f32(h.score)
    w.f32(h.pre_score)
    w.f32(h.sum_score)
    w.f64(h.lnP)
    w.f64(h.pre_lnP)
    w.f64(h.sum_lnP)
    w.f32(h.nexpected)
    w.u32(h.nregions)
    w.u32(h.nclustered)
    w.u32(h.noverlaps)
    w.u32(h.nenvelopes)
    w.u32(len(h.domains))
    w.u32(h.flags)
    w.u32(h.nreported)
    w.u32(h.nincluded)
    w.u32(h.best_domain)
    w.u64(0)  # seqidx
    w.u64(0)  # subseq_start
    presence = H_NAME
    if h.acc:
        presence |= H_ACC
    if h.desc:
        presence |= H_DESC
    w.u8(presence)
    w.cstr(h.name)
    if h.acc:
        w.cstr(h.acc)
    if h.desc:
        w.cstr(h.desc)
    body = w.bytes() + b"".join(_write_domain(d) for d in h.domains)
    return struct.pack(">I", len(body) + 4) + body


def _read_hit(r: _Reader) -> H3Hit:
    start = r.pos
    size = r.u32()
    h = H3Hit()
    r.u32()  # window_length (not kept in h3result)
    h.sortkey = r.f64()
    h.score = r.f32()
    h.pre_score = r.f32()
    h.sum_score = r.f32()
    h.lnP = r.f64()
    h.pre_lnP = r.f64()
    h.sum_lnP = r.f64()
    h.nexpected = r.f32()
    h.nregions = r.u32()
    h.nclustered = r.u32()
    h.noverlaps = r.u32()
    h.nenvelopes = r.u32()
    ndom = r.u32()
    h.flags = r.u32()
    h.nreported = r.u32()
    h.nincluded = r.u32()
    h.best_domain = r.u32()
    r.u64()  # seqidx
    r.u64()  # subseq_start
    presence = r.u8()
    h.name = r.cstr() if presence & H_NAME else ""
    h.acc = r.cstr() if presence & H_ACC else ""
    h.desc = r.cstr() if presence & H_DESC else ""
    h.domains = [_read_domain(r) for _ in range(ndom)]
    if r.pos - start != size:
        raise WireError(f"hit size mismatch: {r.pos - start} != {size}")
    return h


# ---------------------------------------------------------------------------
# whole reply
# ---------------------------------------------------------------------------


def serialize_reply(result: H3Result) -> bytes:
    """H3Result -> hmmpgmd reply message (everything after the 12-byte
    status header)."""
    s = result.stats
    w = _Writer()
    w.f64(0.0)  # elapsed
    w.f64(0.0)  # user
    w.f64(0.0)  # sys
    w.f64(s.Z)
    w.f64(s.domZ)
    w.u8(s.Z_setby)
    w.u8(s.domZ_setby)
    w.u64(s.nmodels)
    w.u64(s.nseqs)
    w.u64(s.n_past_msv)
    w.u64(s.n_past_bias)
    w.u64(s.n_past_vit)
    w.u64(s.n_past_fwd)
    nhits = len(result.hits)
    w.u64(nhits)
    w.u64(s.nreported)
    w.u64(s.nincluded)
    hits = [_write_hit(h) for h in result.hits]
    if nhits:
        # hit_offsets: byte offset of each hit record within the message
        stats_size = sum(len(p) for p in w.parts) + 8 * nhits
        off = stats_size
        for blob in hits:
            w.u64(off)
            off += len(blob)
    else:
        w.u64(NO_OFFSETS)
    return w.bytes() + b"".join(hits)


def parse_reply(msg: bytes) -> H3Result:
    """hmmpgmd reply message -> H3Result."""
    r = _Reader(msg)
    st = H3Stats()
    r.f64()  # elapsed
    r.f64()  # user
    r.f64()  # sys
    st.Z = r.f64()
    st.domZ = r.f64()
    st.Z_setby = r.u8()
    st.domZ_setby = r.u8()
    st.nmodels = r.u64()
    st.nseqs = r.u64()
    st.n_past_msv = r.u64()
    st.n_past_bias = r.u64()
    st.n_past_vit = r.u64()
    st.n_past_fwd = r.u64()
    st.nhits = r.u64()
    st.nreported = r.u64()
    st.nincluded = r.u64()
    first = r.u64()
    if first != NO_OFFSETS and st.nhits:
        for _ in range(st.nhits - 1):
            r.u64()  # remaining hit offsets
    hits = [_read_hit(r) for _ in range(st.nhits)]
    th = H3TopHits(hits=hits, nreported=st.nreported,
                   nincluded=st.nincluded, is_sorted_by_sortkey=True,
                   is_sorted_by_seqidx=False)
    return H3Result(stats=st, tophits=th)
