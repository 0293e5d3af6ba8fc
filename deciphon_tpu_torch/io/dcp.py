"""The .dcp pressed-profile database container (msgpack) — reference-exact.

Byte layout mirrors the reference exactly (c-core/database_writer.c:95-193,
protein.c:234-284, write.c:60-66), including the imm-owned sub-blobs, which
were reverse-engineered from the reference-pressed fixture
(control/tests/files/minifam.dcp) and validated by the exact
oracle byte size 3,609,858 for minifam (c-core/test_press.c:27):

  map(2){
    "header": map(8){
      "magic_number": 0xC6F1, "version": 1,
      "entry_dist": int, "epsilon": float32,
      "abc": <imm abc blob>, "amino": <imm abc blob>,
      "has_ga": bool, "protein_sizes": array(N) of minimal uint,
    },
    "proteins": array(N) of map(10){
      "accession": str, "gencode": int, "consensus": str, "core_size": int,
      "null_nuclt_dist": <nuclt_dist>, "null_emission": bin(f32[1364] LE),
      "bg_nuclt_dist": <nuclt_dist>, "bg_emission": bin(f32[1364] LE),
      "nodes": map((K+1)*3) of repeated "nuclt_dist"/"trans"/"emission",
      "BMk": bin(f32[K] LE),
    },
  }

imm-owned sub-blob layouts (current imm version, deduced + size-validated):

  abc blob   := map(4){"symbols": str,
                       "idx": ext8(type 0, 94 bytes) symbol-index table
                              indexed by char - '!' (127 = invalid,
                              any symbol 'X' -> alphabet size),
                       "any_symbol_id": int ('X' - '!'),
                       "typeid": int (DNA=4, AMINO=2)}
  nuclt_dist := array(2)[ fixarray(4)  of msgpack float32 (nuclt lprobs),
                          array16(125) of msgpack float32 (codon marginals) ]

The older imm/lio generation (the minifam.dcp fixture itself) instead packs
every f32 array as a msgpack ext: type 8 = big-endian f32, type 6 = BE u32
(protein_sizes), with the same logical structure.  The reader accepts both
generations transparently.

Trans row convention (c-core/protein.c:99 protein_absorb): on disk,
nodes[i].trans = model_trans[min(i+1, core_size)] — i.e. the BEGIN row is not
stored (BMk carries the entry distribution).  FrameProfile keeps the model
convention (trans[0] = BEGIN row); reading a .dcp leaves trans[0] = -inf,
which no scan-path consumer reads (ops/costs.py uses rows 1..K-1 only).

Per-protein byte sizes are recorded in the header for random access — the
partitioned reader (c-core/protein_reader.c) seeks straight to any protein.
The reference streams proteins through up to 32 temp chunk files of 4 GB
(database_writer.c:14); here proteins stream to a single temp file (no 4 GB
fd limits apply) and the final byte layout is identical.
"""

from __future__ import annotations

import io as _io
import os
import struct
from dataclasses import dataclass

import msgpack
import numpy as np

from .. import frame
from ..frame import codon_marginals, nuclt_marginal_lprobs
from ..profile import FrameProfile

MAGIC_NUMBER = 0xC6F1
DATABASE_VERSION = 0x01
NODE_SIZE = frame.TABLE_SIZE  # 1364

# imm typeids (from the reference-pressed fixture header)
TYPEID_DNA = 4
TYPEID_AMINO = 2

DNA_SYMBOLS = "ACGT"
AMINO_SYMBOLS = "ACDEFGHIKLMNPQRSTVWY"
ANY_SYMBOL = "X"
SYM_FIRST_CHAR = ord("!")  # imm sym id = char - '!'
SYM_TABLE_SIZE = 94
SYM_NULL_IDX = 0x7F

# lip/lio 1darray ext type codes (observed in the fixture)
EXT_I8 = 0
EXT_U32_BE = 6
EXT_F32_BE = 8


def _abc_idx_table(symbols: str) -> bytes:
    """The imm sym index table, byte-exact vs the fixture blobs.

    127 everywhere except symbols (their index), 'X' (alphabet size = the
    any-symbol index), and a trailing 0 at slot 93 (fixture artifact,
    reproduced for byte equality).
    """
    idx = bytearray([SYM_NULL_IDX] * SYM_TABLE_SIZE)
    for i, c in enumerate(symbols):
        idx[ord(c) - SYM_FIRST_CHAR] = i
    idx[ord(ANY_SYMBOL) - SYM_FIRST_CHAR] = len(symbols)
    idx[SYM_TABLE_SIZE - 1] = 0
    return bytes(idx)


def _pack_abc(packer, symbols: str, typeid: int) -> bytes:
    out = [packer.pack_map_header(4)]
    out.append(packer.pack("symbols"))
    out.append(packer.pack(symbols))
    out.append(packer.pack("idx"))
    out.append(packer.pack(msgpack.ExtType(EXT_I8, _abc_idx_table(symbols))))
    out.append(packer.pack("any_symbol_id"))
    out.append(packer.pack(ord(ANY_SYMBOL) - SYM_FIRST_CHAR))
    out.append(packer.pack("typeid"))
    out.append(packer.pack(typeid))
    return b"".join(out)


def _f32bin(packer, arr: np.ndarray) -> bytes:
    """Deciphon-level f32 array: msgpack bin of little-endian f32
    (c-core/write.c:60-66 write_f32array)."""
    a = np.ascontiguousarray(arr, dtype="<f4")
    return packer.pack(a.tobytes())


def _f32_msgpack_array(values: np.ndarray) -> bytes:
    """imm-level f32 array: msgpack array of float32 scalars (0xca)."""
    a = np.ascontiguousarray(values, dtype=">f4").reshape(-1)
    n = a.shape[0]
    if n <= 15:
        head = struct.pack("B", 0x90 | n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xDC, n)
    else:
        head = struct.pack(">BI", 0xDD, n)
    raw = a.tobytes()  # big-endian f32 payloads (msgpack float32 is BE)
    body = b"".join(b"\xca" + raw[4 * i:4 * i + 4] for i in range(n))
    return head + body


def _pack_nuclt_dist(packer, nuclt_lprobs: np.ndarray,
                     codon_marg: np.ndarray) -> bytes:
    """array(2)[nuclt lprobs f32[4], codon marginals f32[125]]
    (c-core/nuclt_dist.c nuclt_dist_pack + current imm pack layout)."""
    out = [packer.pack_array_header(2)]
    out.append(_f32_msgpack_array(np.asarray(nuclt_lprobs, np.float32)))
    out.append(_f32_msgpack_array(np.asarray(codon_marg, np.float32).reshape(-1)))
    return b"".join(out)


class DcpWriter:
    """Streams pressed profiles into a .dcp file, reference byte layout.

    Proteins stage through ROTATING temp chunk files of `split_size`
    bytes (the reference's 32 x 4 GB chunked writer,
    c-core/database_writer.c:14,201-207): memory stays bounded at one
    protein blob regardless of database size, and no single temp file
    outgrows filesystems with per-file limits.  The chunks concatenate
    into the final file at close, so the byte layout is identical to an
    unchunked write.
    """

    SPLIT_SIZE = 4 << 30  # database_writer.c:14 SPLIT_SIZE (4 GB)
    MAX_CHUNKS = 32  # database_writer.h DATABASE_WRITER_CHUNKS

    def __init__(self, path: str, entry_dist: int, epsilon: float,
                 split_size: int | None = None):
        self.path = path
        self.entry_dist = entry_dist
        self.epsilon = epsilon
        self.has_ga = False
        self.sizes: list[int] = []
        self.split_size = split_size or self.SPLIT_SIZE
        self._chunk_paths: list[str] = []
        self._tmp = None
        self._rotate()
        self._packer = msgpack.Packer(use_single_float=True, autoreset=True)

    def _rotate(self) -> None:
        if self._tmp is not None:
            self._tmp.close()
        if len(self._chunk_paths) >= self.MAX_CHUNKS:
            raise DcpFormatError(
                f"database exceeds {self.MAX_CHUNKS} chunks of "
                f"{self.split_size} bytes (the reference's "
                f"32 x 4 GB writer limit, database_writer.c:14)")
        p = f"{self.path}.proteins.{len(self._chunk_paths)}.tmp"
        self._chunk_paths.append(p)
        self._tmp = open(p, "wb")

    def set_has_ga(self, has_ga: bool) -> None:
        self.has_ga = has_ga

    def pack_profile(self, p: FrameProfile) -> None:
        blob = pack_protein(self._packer, p)
        self.sizes.append(len(blob))
        self._tmp.write(blob)
        # rotate AFTER crossing the split, exactly like the reference
        # (database_writer.c:201-207 checks the tell after the write)
        if self._tmp.tell() >= self.split_size:
            self._rotate()

    def close(self) -> str:
        self._tmp.close()
        pk = self._packer
        with open(self.path, "wb") as fp:
            fp.write(pk.pack_map_header(2))
            fp.write(pk.pack("header"))
            fp.write(pk.pack_map_header(8))
            fp.write(pk.pack("magic_number"))
            fp.write(pk.pack(MAGIC_NUMBER))
            fp.write(pk.pack("version"))
            fp.write(pk.pack(DATABASE_VERSION))
            fp.write(pk.pack("entry_dist"))
            fp.write(pk.pack(self.entry_dist))
            fp.write(pk.pack("epsilon"))
            fp.write(pk.pack(float(np.float32(self.epsilon))))
            fp.write(pk.pack("abc"))
            fp.write(_pack_abc(pk, DNA_SYMBOLS, TYPEID_DNA))
            fp.write(pk.pack("amino"))
            fp.write(_pack_abc(pk, AMINO_SYMBOLS, TYPEID_AMINO))
            fp.write(pk.pack("has_ga"))
            fp.write(pk.pack(self.has_ga))
            fp.write(pk.pack("protein_sizes"))
            fp.write(pk.pack_array_header(len(self.sizes)))
            for s in self.sizes:
                fp.write(pk.pack(s))
            fp.write(pk.pack("proteins"))
            fp.write(pk.pack_array_header(len(self.sizes)))
            for cp in self._chunk_paths:
                with open(cp, "rb") as tmp:
                    while True:
                        chunk = tmp.read(1 << 22)
                        if not chunk:
                            break
                        fp.write(chunk)
        for cp in self._chunk_paths:
            os.unlink(cp)
        return self.path


def pack_protein(packer, p: FrameProfile) -> bytes:
    """Serialize one pressed profile (c-core/protein.c:234-284 layout)."""
    null_q = nuclt_marginal_lprobs(p.null_codon_lprobs.astype(np.float64))
    bg_q = nuclt_marginal_lprobs(p.bg_codon_lprobs.astype(np.float64))
    null_marg = codon_marginals(p.null_codon_lprobs.astype(np.float64))
    bg_marg = codon_marginals(p.bg_codon_lprobs.astype(np.float64))
    match_q = nuclt_marginal_lprobs(p.match_codon_lprobs.astype(np.float64))
    match_marg = codon_marginals(p.match_codon_lprobs.astype(np.float64))

    K = p.core_size
    # Disk row i = model trans row min(i+1, K) (protein.c:99).
    disk_trans = p.trans[np.minimum(np.arange(K + 1) + 1, K)]

    out = [packer.pack_map_header(10)]
    w = out.append
    w(packer.pack("accession"))
    w(packer.pack(p.accession))
    w(packer.pack("gencode"))
    w(packer.pack(p.gencode_id))
    w(packer.pack("consensus"))
    w(packer.pack(p.consensus))
    w(packer.pack("core_size"))
    w(packer.pack(K))
    w(packer.pack("null_nuclt_dist"))
    w(_pack_nuclt_dist(packer, null_q, null_marg))
    w(packer.pack("null_emission"))
    w(_f32bin(packer, p.null_emission))
    w(packer.pack("bg_nuclt_dist"))
    w(_pack_nuclt_dist(packer, bg_q, bg_marg))
    w(packer.pack("bg_emission"))
    w(_f32bin(packer, p.bg_emission))
    w(packer.pack("nodes"))
    w(packer.pack_map_header((K + 1) * 3))
    for i in range(K + 1):
        w(packer.pack("nuclt_dist"))
        w(_pack_nuclt_dist(packer, match_q[i], match_marg[i]))
        w(packer.pack("trans"))
        w(_f32bin(packer, disk_trans[i]))
        w(packer.pack("emission"))
        w(_f32bin(packer, p.match_emission[i]))
    w(packer.pack("BMk"))
    w(_f32bin(packer, p.BMk))
    return b"".join(out)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


class DcpFormatError(ValueError):
    pass


def _f32arr(val) -> np.ndarray:
    """Decode any generation's f32 array value."""
    if isinstance(val, msgpack.ExtType):
        if val.code != EXT_F32_BE:
            raise DcpFormatError(f"unexpected ext type {val.code} for f32 array")
        return np.frombuffer(val.data, ">f4").astype(np.float32)
    if isinstance(val, (bytes, bytearray)):
        return np.frombuffer(bytes(val), "<f4").copy()
    if isinstance(val, (list, tuple)):
        return np.asarray(val, dtype=np.float32)
    raise DcpFormatError(f"cannot decode f32 array from {type(val).__name__}")


def _u32arr(val) -> list[int]:
    if isinstance(val, msgpack.ExtType):
        if val.code != EXT_U32_BE:
            raise DcpFormatError(f"unexpected ext type {val.code} for u32 array")
        return [int(x) for x in np.frombuffer(val.data, ">u4")]
    if isinstance(val, (list, tuple)):
        return [int(x) for x in val]
    raise DcpFormatError(f"cannot decode u32 array from {type(val).__name__}")


@dataclass
class DcpHeader:
    magic_number: int
    version: int
    entry_dist: int
    epsilon: float
    abc: str
    amino: str
    has_ga: bool
    protein_sizes: list[int]


def _pairs(obj):
    """Normalize an unpacked map (list of pairs) to iterable of pairs."""
    if isinstance(obj, dict):
        return list(obj.items())
    return obj


def _as_map(obj) -> dict:
    d = {}
    for k, v in _pairs(obj):
        d.setdefault(k, v)
    return d


class DcpReader:
    """Random-access .dcp reader (c-core/database_reader.c semantics).

    Validates magic/version/epsilon (database_reader.c:37-75); exposes
    header metadata, per-protein byte offsets, and lazy profile decoding.
    Opens both imm generations (current bin-LE layout and the older
    ExtType big-endian layout of the reference fixture).
    """

    def __init__(self, path: str):
        self.path = path
        self._fp = open(path, "rb")
        self._read_header()

    def close(self):
        self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_header(self) -> None:
        unpacker = msgpack.Unpacker(
            self._fp, object_pairs_hook=lambda ps: ps, strict_map_key=False,
            max_buffer_size=1 << 31)
        try:
            self._parse_header(unpacker)
        except DcpFormatError:
            raise
        except Exception as exc:  # malformed msgpack, bad unicode, EOF...
            raise DcpFormatError(f"corrupt .dcp file: {exc}") from exc

    def _parse_header(self, unpacker) -> None:
        top_n = unpacker.read_map_header()
        if top_n != 2:
            raise DcpFormatError("expected top-level map(2)")
        key = unpacker.unpack()
        if key != "header":
            raise DcpFormatError("expected 'header' key")
        header = _as_map(unpacker.unpack())
        if header.get("magic_number") != MAGIC_NUMBER:
            raise DcpFormatError("bad magic number")
        if header.get("version") != DATABASE_VERSION:
            raise DcpFormatError("unsupported database version")
        eps = float(header["epsilon"])
        if not (0.0 <= eps <= 1.0):
            raise DcpFormatError("epsilon out of range")
        self.header = DcpHeader(
            magic_number=header["magic_number"],
            version=header["version"],
            entry_dist=header["entry_dist"],
            epsilon=eps,
            abc=_as_map(header["abc"])["symbols"],
            amino=_as_map(header["amino"])["symbols"],
            has_ga=bool(header["has_ga"]),
            protein_sizes=_u32arr(header["protein_sizes"]),
        )
        key = unpacker.unpack()
        if key != "proteins":
            raise DcpFormatError("expected 'proteins' key")
        n = unpacker.read_array_header()
        if n != len(self.header.protein_sizes):
            raise DcpFormatError("protein count mismatch")
        # File offset where protein 0 starts = bytes unpacked so far
        # (Unpacker.tell counts consumed bytes, independent of read-ahead).
        base = unpacker.tell()
        self._base = base
        sizes = self.header.protein_sizes
        self._offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1] + base

    @property
    def num_proteins(self) -> int:
        return len(self.header.protein_sizes)

    def protein_blob(self, idx: int) -> bytes:
        self._fp.seek(self._offsets[idx])
        return self._fp.read(self.header.protein_sizes[idx])

    def read_profile(self, idx: int) -> FrameProfile:
        return unpack_protein(self.protein_blob(idx), self.header)

    def __iter__(self):
        for i in range(self.num_proteins):
            yield self.read_profile(i)


def unpack_protein(blob: bytes, header: DcpHeader) -> FrameProfile:
    unpacker = msgpack.Unpacker(
        _io.BytesIO(blob), object_pairs_hook=lambda ps: ps,
        strict_map_key=False, max_buffer_size=1 << 31)
    n = unpacker.read_map_header()
    if n != 10:
        raise DcpFormatError("expected protein map(10)")
    fields = {}
    for _ in range(10):
        k = unpacker.unpack()
        if k == "nodes":
            nk = unpacker.read_map_header()
            nodes = []
            for _ in range(nk):
                nodes.append((unpacker.unpack(), unpacker.unpack()))
            fields["nodes"] = nodes
        else:
            fields[k] = unpacker.unpack()

    K = fields["core_size"]
    node_items = fields["nodes"]
    if len(node_items) != (K + 1) * 3:
        raise DcpFormatError("bad nodes map size")
    disk_trans = np.zeros((K + 1, 7), np.float32)
    match_em = np.zeros((K + 1, NODE_SIZE), np.float32)
    match_marg = np.zeros((K + 1, 5, 5, 5), np.float32)
    ni = 0
    for key, val in node_items:
        i = ni // 3
        if key == "nuclt_dist":
            _, codonm = val
            match_marg[i] = _f32arr(codonm).reshape(5, 5, 5)
        elif key == "trans":
            disk_trans[i] = _f32arr(val)
        elif key == "emission":
            match_em[i] = _f32arr(val)
        else:
            raise DcpFormatError(f"unexpected node key {key!r}")
        ni += 1

    # Undo the disk row shift: model_trans[i] = disk_trans[i-1] for i>=1;
    # the BEGIN row is not stored (BMk is the entry distribution) — leave
    # it at -inf, no scan consumer reads it (ops/costs.py uses rows 1..K-1).
    trans = np.full((K + 1, 7), -np.inf, np.float32)
    trans[1:] = disk_trans[:K]

    def codons_from_marg(marg: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(marg[..., :4, :4, :4])

    null_marg = _f32arr(fields["null_nuclt_dist"][1]).reshape(5, 5, 5)
    bg_marg = _f32arr(fields["bg_nuclt_dist"][1]).reshape(5, 5, 5)

    return FrameProfile(
        accession=fields["accession"],
        name=fields["accession"],
        core_size=K,
        consensus=fields["consensus"],
        gencode_id=fields["gencode"],
        epsilon=header.epsilon,
        entry_dist=header.entry_dist,
        has_ga=header.has_ga,
        trans=trans,
        BMk=_f32arr(fields["BMk"]),
        match_emission=match_em,
        null_emission=_f32arr(fields["null_emission"]),
        bg_emission=_f32arr(fields["bg_emission"]),
        match_codon_lprobs=codons_from_marg(match_marg),
        null_codon_lprobs=codons_from_marg(null_marg[None])[0],
        bg_codon_lprobs=codons_from_marg(bg_marg[None])[0],
    )


def read_dcp_profiles(path: str) -> tuple[DcpHeader, list[FrameProfile]]:
    with DcpReader(path) as r:
        return r.header, list(r)
