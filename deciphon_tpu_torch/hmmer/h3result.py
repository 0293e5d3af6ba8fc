"""H3Result: HMMER search results attached to products (.h3r blobs).

This parses and writes the REAL h3result serialization used by the
reference (the h3result C library; written per confirmed hit by
c-core/product_thread.c:81-110 and re-read by snap/deciphon_snap/hmmer.py).
The schema was decoded from the reference-produced fixture blobs in
/root/reference/control/tests/files/snap.dcs and round-trips byte-exactly:

  {"h3result": {"stats": [13 fields], "tophits": [5 fields]}}

  stats   := [Z f64, domZ f64, Z_setby, domZ_setby, nmodels, nseqs,
              n_past_msv, n_past_bias, n_past_vit, n_past_fwd,
              nhits, nreported, nincluded]
  tophits := [{"hits": [hit...]}, nreported, nincluded,
              is_sorted_by_sortkey, is_sorted_by_seqidx]
  hit     := [name, acc, desc, sortkey f64, score f32, pre_score f32,
              sum_score f32, lnP f64, pre_lnP f64, sum_lnP f64,
              nexpected f32, nregions, nclustered, noverlaps, nenvelopes,
              flags, nreported, nincluded, best_domain, {"domains": [...]}]
  domain  := [ienv, jenv, iali, jali, envsc f32, domcorrection f32,
              dombias f32, oasc f32, bitscore f32, lnP f64,
              is_reported bool, is_included bool, scale_per_pos [f32...],
              {"alidisplay": [...]}]

  alidisplay := [presence, rfline, mmline, csline, model, mline, aseq,
               ntseq, ppline, N, hmmname, hmmacc, hmmdesc, hmmfrom,
               hmmto, M, sqname, sqacc, sqdesc, sqfrom, sqto, L]
              (ints and plain strings; presence bits: RFLINE=1 MMLINE=2
               CSLINE=4 PPLINE=8 ASEQ=16 NTSEQ=32)

Views: `targets_table` / `domains_table` render the hmmsearch
--tblout/--domtblout formats that the reference obtains from the C
library's print functions (snap/deciphon_snap/hmmer.py:15-65).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import msgpack

__all__ = ["H3Result", "H3Stats", "H3TopHits", "H3Hit", "H3Domain",
           "H3AliDisplay"]

PRESENCE_RFLINE = 1
PRESENCE_MMLINE = 2
PRESENCE_CSLINE = 4
PRESENCE_PPLINE = 8
PRESENCE_ASEQ = 16
PRESENCE_NTSEQ = 32


@dataclass
class H3AliDisplay:
    presence: int = 0
    rfline: str = ""
    mmline: str = ""
    csline: str = ""
    model: str = ""  # aligned profile consensus row
    mline: str = ""  # midline (match/+/space)
    aseq: str = ""  # aligned query sequence row
    ntseq: str = ""
    ppline: str = ""  # posterior probability row
    N: int = 0  # alignment length
    hmmname: str = ""
    hmmacc: str = ""
    hmmdesc: str = ""
    hmmfrom: int = 0  # 1-based profile coords
    hmmto: int = 0
    M: int = 0  # profile length
    sqname: str = ""
    sqacc: str = ""
    sqdesc: str = ""
    sqfrom: int = 0  # 1-based query coords
    sqto: int = 0
    L: int = 0  # query length

    @staticmethod
    def presence_of(rfline="", mmline="", csline="", ppline="", aseq="",
                    ntseq="") -> int:
        p = 0
        if rfline:
            p |= PRESENCE_RFLINE
        if mmline:
            p |= PRESENCE_MMLINE
        if csline:
            p |= PRESENCE_CSLINE
        if ppline:
            p |= PRESENCE_PPLINE
        if aseq:
            p |= PRESENCE_ASEQ
        if ntseq:
            p |= PRESENCE_NTSEQ
        return p

    def to_wire(self) -> list:
        return [
            self.presence, self.rfline, self.mmline, self.csline,
            self.model, self.mline, self.aseq, self.ntseq, self.ppline,
            self.N, self.hmmname, self.hmmacc, self.hmmdesc, self.hmmfrom,
            self.hmmto, self.M, self.sqname, self.sqacc, self.sqdesc,
            self.sqfrom, self.sqto, self.L,
        ]

    @classmethod
    def from_wire(cls, w: list) -> "H3AliDisplay":
        if len(w) != 22:
            raise ValueError(f"alidisplay expects 22 fields, got {len(w)}")
        return cls(
            presence=w[0], rfline=w[1], mmline=w[2], csline=w[3],
            model=w[4], mline=w[5], aseq=w[6], ntseq=w[7], ppline=w[8],
            N=w[9], hmmname=w[10], hmmacc=w[11], hmmdesc=w[12],
            hmmfrom=w[13], hmmto=w[14], M=w[15], sqname=w[16], sqacc=w[17],
            sqdesc=w[18], sqfrom=w[19], sqto=w[20], L=w[21],
        )


class _F32(float):
    """Marker: pack as msgpack float32 (the C lib packs float fields
    as f32 and double fields as f64)."""


def _f32(x) -> float:
    return _F32(x)


@dataclass
class H3Domain:
    ienv: int = 0  # 1-based envelope coords on the query
    jenv: int = 0
    iali: int = 0  # 1-based alignment coords
    jali: int = 0
    envsc: float = 0.0
    domcorrection: float = 0.0
    dombias: float = 0.0
    oasc: float = 0.0
    bitscore: float = 0.0
    lnP: float = 0.0  # log P-value
    is_reported: bool = True
    is_included: bool = True
    scale_per_pos: list[float] = field(default_factory=list)
    ad: H3AliDisplay = field(default_factory=H3AliDisplay)

    # -- back-compat convenience names used around the codebase ----------
    @property
    def env_start(self) -> int:
        return self.ienv

    @property
    def env_stop(self) -> int:
        return self.jenv

    @property
    def ali_start(self) -> int:
        return self.iali

    @property
    def ali_stop(self) -> int:
        return self.jali

    @property
    def hmm_start(self) -> int:
        return self.ad.hmmfrom

    @property
    def hmm_stop(self) -> int:
        return self.ad.hmmto

    @property
    def score(self) -> float:
        return self.bitscore

    @property
    def query_display(self) -> str:
        return self.ad.aseq

    @property
    def model_display(self) -> str:
        return self.ad.model

    @property
    def match_display(self) -> str:
        return self.ad.mline

    def to_wire(self):
        return [
            self.ienv, self.jenv, self.iali, self.jali, _f32(self.envsc),
            _f32(self.domcorrection), _f32(self.dombias), _f32(self.oasc),
            _f32(self.bitscore), float(self.lnP), bool(self.is_reported),
            bool(self.is_included), [_f32(v) for v in self.scale_per_pos],
            {"alidisplay": self.ad.to_wire()},
        ]

    @classmethod
    def from_wire(cls, w) -> "H3Domain":
        if len(w) != 14:
            raise ValueError(f"domain expects 14 fields, got {len(w)}")
        return cls(
            ienv=w[0], jenv=w[1], iali=w[2], jali=w[3], envsc=w[4],
            domcorrection=w[5], dombias=w[6], oasc=w[7], bitscore=w[8],
            lnP=w[9], is_reported=bool(w[10]), is_included=bool(w[11]),
            scale_per_pos=list(w[12]),
            ad=H3AliDisplay.from_wire(w[13]["alidisplay"]),
        )


@dataclass
class H3Hit:
    name: str = ""
    acc: str = ""
    desc: str = ""
    sortkey: float = 0.0
    score: float = 0.0  # full-sequence bit score
    pre_score: float = 0.0
    sum_score: float = 0.0
    lnP: float = 0.0  # log P-value
    pre_lnP: float = 0.0
    sum_lnP: float = 0.0
    nexpected: float = 0.0
    nregions: int = 0
    nclustered: int = 0
    noverlaps: int = 0
    nenvelopes: int = 0
    flags: int = 0
    nreported: int = 0
    nincluded: int = 0
    best_domain: int = 0
    domains: list[H3Domain] = field(default_factory=list)

    def logevalue(self, Z: float) -> float:
        return self.lnP + math.log(Z)

    def to_wire(self):
        return [
            self.name, self.acc, self.desc, float(self.sortkey),
            _f32(self.score), _f32(self.pre_score), _f32(self.sum_score),
            float(self.lnP), float(self.pre_lnP), float(self.sum_lnP),
            _f32(self.nexpected), self.nregions, self.nclustered,
            self.noverlaps, self.nenvelopes, self.flags, self.nreported,
            self.nincluded, self.best_domain,
            {"domains": [d.to_wire() for d in self.domains]},
        ]

    @classmethod
    def from_wire(cls, w) -> "H3Hit":
        if len(w) != 20:
            raise ValueError(f"hit expects 20 fields, got {len(w)}")
        return cls(
            name=w[0], acc=w[1], desc=w[2], sortkey=w[3], score=w[4],
            pre_score=w[5], sum_score=w[6], lnP=w[7], pre_lnP=w[8],
            sum_lnP=w[9], nexpected=w[10], nregions=w[11], nclustered=w[12],
            noverlaps=w[13], nenvelopes=w[14], flags=w[15], nreported=w[16],
            nincluded=w[17], best_domain=w[18],
            domains=[H3Domain.from_wire(d) for d in w[19]["domains"]],
        )


@dataclass
class H3Stats:
    Z: float = 0.0
    domZ: float = 0.0
    Z_setby: int = 0
    domZ_setby: int = 0
    nmodels: int = 0
    nseqs: int = 0
    n_past_msv: int = 0
    n_past_bias: int = 0
    n_past_vit: int = 0
    n_past_fwd: int = 0
    nhits: int = 0
    nreported: int = 0
    nincluded: int = 0

    def to_wire(self):
        return [float(self.Z), float(self.domZ), self.Z_setby,
                self.domZ_setby, self.nmodels, self.nseqs, self.n_past_msv,
                self.n_past_bias, self.n_past_vit, self.n_past_fwd,
                self.nhits, self.nreported, self.nincluded]

    @classmethod
    def from_wire(cls, w) -> "H3Stats":
        if len(w) != 13:
            raise ValueError(f"stats expects 13 fields, got {len(w)}")
        return cls(*w)


@dataclass
class H3TopHits:
    hits: list[H3Hit] = field(default_factory=list)
    nreported: int = 0
    nincluded: int = 0
    is_sorted_by_sortkey: bool = True
    is_sorted_by_seqidx: bool = False

    def to_wire(self):
        return [{"hits": [h.to_wire() for h in self.hits]}, self.nreported,
                self.nincluded, bool(self.is_sorted_by_sortkey),
                bool(self.is_sorted_by_seqidx)]

    @classmethod
    def from_wire(cls, w) -> "H3TopHits":
        if len(w) != 5:
            raise ValueError(f"tophits expects 5 fields, got {len(w)}")
        return cls(hits=[H3Hit.from_wire(h) for h in w[0]["hits"]],
                   nreported=w[1], nincluded=w[2],
                   is_sorted_by_sortkey=bool(w[3]),
                   is_sorted_by_seqidx=bool(w[4]))


def _packb(obj) -> bytes:
    """msgpack pack preserving the f32/f64 float split via _F32 markers."""
    out = bytearray()
    pk64 = msgpack.Packer(autoreset=True)
    pk32 = msgpack.Packer(use_single_float=True, autoreset=True)

    def emit(o):
        if isinstance(o, _F32):
            out.extend(pk32.pack(float(o)))
        elif isinstance(o, bool):
            out.extend(pk64.pack(o))
        elif isinstance(o, (int, str, bytes, float)) or o is None:
            out.extend(pk64.pack(o))
        elif isinstance(o, (list, tuple)):
            out.extend(pk64.pack_array_header(len(o)))
            for v in o:
                emit(v)
        elif isinstance(o, dict):
            out.extend(pk64.pack_map_header(len(o)))
            for k, v in o.items():
                emit(k)
                emit(v)
        else:
            raise TypeError(f"unpackable: {o!r}")

    emit(obj)
    return bytes(out)


@dataclass
class H3Result:
    stats: H3Stats = field(default_factory=H3Stats)
    tophits: H3TopHits = field(default_factory=H3TopHits)

    # -- convenience ------------------------------------------------------
    @property
    def Z(self) -> float:
        return self.stats.Z

    @property
    def hits(self) -> list[H3Hit]:
        return self.tophits.hits

    @property
    def nhits(self) -> int:
        return len(self.tophits.hits)

    def hit_logevalue(self, i: int) -> float:
        return self.hits[i].logevalue(self.stats.Z)

    @classmethod
    def single_hit(cls, name: str, acc: str, score: float, lnP: float,
                   Z: float, qlen: int, seqlen: int,
                   domains: list[H3Domain] | None = None) -> "H3Result":
        domains = domains or []
        hit = H3Hit(name=name, acc=acc, desc="", sortkey=score, score=score,
                    pre_score=score, sum_score=score, lnP=lnP, pre_lnP=lnP,
                    sum_lnP=lnP, nexpected=1.0, nregions=1, nclustered=0,
                    noverlaps=0, nenvelopes=max(len(domains), 1), flags=3,
                    nreported=1, nincluded=1, best_domain=0, domains=domains)
        stats = H3Stats(Z=Z, domZ=1.0, Z_setby=0, domZ_setby=0,
                        nmodels=int(Z), nseqs=1, n_past_msv=1,
                        n_past_bias=1, n_past_vit=1, n_past_fwd=1,
                        nhits=1, nreported=1, nincluded=1)
        return cls(stats=stats,
                   tophits=H3TopHits(hits=[hit], nreported=1, nincluded=1))

    # -- serialization (reference h3result schema) ------------------------
    def to_blob(self) -> bytes:
        return _packb({"h3result": {"stats": self.stats.to_wire(),
                                    "tophits": self.tophits.to_wire()}})

    @classmethod
    def from_blob(cls, blob: bytes) -> "H3Result":
        obj = msgpack.unpackb(blob, strict_map_key=False)
        if not isinstance(obj, dict) or "h3result" not in obj:
            raise ValueError("not an h3result blob")
        body = obj["h3result"]
        return cls(stats=H3Stats.from_wire(body["stats"]),
                   tophits=H3TopHits.from_wire(body["tophits"]))

    # -- text views (the C library's print_targets/domains equivalents) ---
    def targets_table(self, query_name: str = "-") -> str:
        """hmmsearch --tblout format (one line per hit)."""
        lines = []
        lines.append("#" + " " * 31 + "--- full sequence ---- "
                     "--- best 1 domain ---- --- domain number estimation ----")
        lines.append(
            "# target name        accession  query name           accession "
            "   E-value  score  bias   E-value  score  bias   exp reg clu "
            " ov env dom rep inc description of target")
        lines.append("#" + "-" * 19 + " " + "-" * 10 + " " + "-" * 20 + " "
                     + "-" * 10 + " " + "-" * 9 + " " + "-" * 6 + " "
                     + "-" * 5 + " " + "-" * 9 + " " + "-" * 6 + " "
                     + "-" * 5 + " " + "-" * 3 + " " + "-" * 3 + " "
                     + "-" * 3 + " " + "-" * 3 + " " + "-" * 3 + " "
                     + "-" * 3 + " " + "-" * 3 + " " + "-" * 3 + " "
                     + "-" * 21)
        Z, domZ = self.stats.Z, max(self.stats.domZ, 1e-300)
        for h in self.hits:
            best = h.domains[h.best_domain] if h.domains else H3Domain()
            lines.append(
                "%-20s %-10s %-20s %-10s %9.2g %6.1f %5.1f %9.2g %6.1f "
                "%5.1f %5.1f %3d %3d %3d %3d %3d %3d %3d %s"
                % (h.name, h.acc or "-", query_name, "-",
                   math.exp(min(h.lnP + math.log(Z), 700)), h.score,
                   max(h.pre_score - h.score, 0.0),
                   math.exp(min(best.lnP + math.log(domZ), 700)),
                   best.bitscore, max(best.dombias, 0.0), h.nexpected,
                   h.nregions, h.nclustered, h.noverlaps, h.nenvelopes,
                   len(h.domains), h.nreported, h.nincluded, h.desc or "-"))
        lines.append("#")
        return "\n".join(lines) + "\n"

    def domains_table(self, query_name: str = "-", qlen: int = 0) -> str:
        """hmmsearch --domtblout format (one line per domain)."""
        lines = []
        lines.append("#" + " " * 55 + "--- full sequence --- "
                     "-------------- this domain -------------   hmm coord   "
                     "ali coord   env coord")
        lines.append(
            "# target name        accession   tlen query name           "
            "accession   qlen   E-value  score  bias   #  of  c-Evalue  "
            "i-Evalue  score  bias  from    to  from    to  from    to  "
            "acc description of target")
        lines.append("#" + "-" * 19 + " " + "-" * 10 + " " + "-" * 5 + " "
                     + "-" * 20 + " " + "-" * 10 + " " + "-" * 5 + " "
                     + "-" * 9 + " " + "-" * 6 + " " + "-" * 5 + " "
                     + "-" * 3 + " " + "-" * 3 + " " + "-" * 9 + " "
                     + "-" * 9 + " " + "-" * 6 + " " + "-" * 5 + " "
                     + "-" * 5 + " " + "-" * 5 + " " + "-" * 5 + " "
                     + "-" * 5 + " " + "-" * 5 + " " + "-" * 5 + " "
                     + "-" * 4 + " " + "-" * 21)
        Z, domZ = self.stats.Z, max(self.stats.domZ, 1e-300)
        for h in self.hits:
            for di, d in enumerate(h.domains):
                ad = d.ad
                denom = max(d.jali - d.iali + 1 + ad.hmmto - ad.hmmfrom + 1, 1)
                acc_col = d.oasc / (denom / 2.0) if denom else 0.0
                lines.append(
                    "%-20s %-10s %5d %-20s %-10s %5d %9.2g %6.1f %5.1f %3d "
                    "%3d %9.2g %9.2g %6.1f %5.1f %5d %5d %5d %5d %5d %5d "
                    "%4.2f %s"
                    % (h.name, h.acc or "-", ad.M, query_name, "-",
                       qlen or ad.L,
                       math.exp(min(h.lnP + math.log(Z), 700)), h.score,
                       max(h.pre_score - h.score, 0.0), di + 1,
                       len(h.domains),
                       math.exp(min(d.lnP + math.log(domZ), 700)),
                       math.exp(min(d.lnP + math.log(Z), 700)),
                       d.bitscore, max(d.dombias, 0.0), ad.hmmfrom, ad.hmmto,
                       d.iali, d.jali, d.ienv, d.jenv, min(acc_col, 1.0),
                       h.desc or "-"))
        lines.append("#")
        return "\n".join(lines) + "\n"
