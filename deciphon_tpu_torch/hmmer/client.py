"""hmmpgmd TCP client (parity: c-core/hmmer.c + the h3client wire usage).

Request framing to hmmpgmd (HMMER3's daemon): one line of search options
prefixed with '@', the query sequence in FASTA form, and a '//' terminator.
Options mirror the reference exactly (hmmer.c:83-92): per-hit queries pin
the profile with --hmmdb_range IDX..IDX and use --cut_ga when the database
carries GA thresholds, else `-Z num_proteins -E 1e-10`.  Retry policy is
the reference's: 30 attempts, 30 s socket timeout (hmmer.c:9-10).

The binary reply is parsed by a pluggable `parse_response` callable.  The
default parser decodes HMMER's native daemon serialization (hmmer/wire.py
— stats + serialized hits/domains/alidisplays); the in-repo fake daemon
emits the same bytes, so tests exercise the real code path.  For defense
in depth against protocol-revision skew, a reply that fails the binary
parse is retried as a bare msgpack h3result payload before erroring.
"""

from __future__ import annotations

import socket
import struct

from .h3result import H3Result
from .wire import WireError, parse_reply

__all__ = ["HMMERClient", "HMMERError", "recv_exact", "send_request",
           "read_response"]

NUM_RETRIES = 30  # c-core/hmmer.c:9
TIMEOUT_SECONDS = 30.0  # c-core/hmmer.c:10

STATUS_FMT = "!IQ"  # status u32 + msg_size u64, network order, 12 bytes
STATUS_SIZE = struct.calcsize(STATUS_FMT)


class HMMERError(RuntimeError):
    pass


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise HMMERError("daemon closed the connection")
        buf.extend(chunk)
    return bytes(buf)


def send_request(sock: socket.socket, cmd: str, seq: str) -> None:
    payload = f"@{cmd}\n>seq\n{seq}\n//".encode()
    sock.sendall(payload)


def read_response(sock: socket.socket) -> tuple[int, bytes]:
    """Returns (status, message bytes)."""
    header = recv_exact(sock, STATUS_SIZE)
    status, msg_size = struct.unpack(STATUS_FMT, header)
    msg = recv_exact(sock, msg_size) if msg_size else b""
    return status, msg


def default_parse_response(status: int, msg: bytes) -> H3Result:
    if status != 0:
        raise HMMERError(f"hmmpgmd error {status}: {msg[:200]!r}")
    try:
        return parse_reply(msg)
    except WireError:
        # protocol-revision fallback: accept a bare msgpack h3result
        try:
            return H3Result.from_blob(msg)
        except ValueError:
            raise HMMERError("unparseable hmmpgmd reply") from None


class HMMERClient:
    """Per-scan confirmation client (one socket, serial queries)."""

    def __init__(self, host: str, port: int, num_proteins: int,
                 has_ga: bool, parse_response=default_parse_response,
                 warmup: bool = True):
        self.host = host
        self.port = port
        self.num_proteins = num_proteins
        self.has_ga = has_ga
        self.parse_response = parse_response
        self.sock: socket.socket | None = None
        self.dial()
        if warmup:
            self.warmup()

    def dial(self) -> None:
        self.sock = socket.create_connection(
            (self.host, self.port), timeout=TIMEOUT_SECONDS)

    def hangup(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.hangup()

    def warmup(self) -> None:
        """First query against profile 0 (hmmer.c:74-81)."""
        send_request(self.sock, "--hmmdb 1 --hmmdb_range 0..0 --acc", "")
        read_response(self.sock)

    def get(self, hmmidx: int, seq: str) -> H3Result:
        if self.has_ga:
            cmd = (f"--hmmdb 1 --hmmdb_range {hmmidx}..{hmmidx} "
                   f"--acc --cut_ga")
        else:
            cmd = (f"--hmmdb 1 --hmmdb_range {hmmidx}..{hmmidx} "
                   f"--acc -Z {self.num_proteins} -E 1e-10")
        last: Exception | None = None
        for _ in range(NUM_RETRIES):
            try:
                send_request(self.sock, cmd, seq)
                status, msg = read_response(self.sock)
                return self.parse_response(status, msg)
            except socket.timeout as exc:
                last = exc
                continue
        raise HMMERError(f"max retries reached: {last}")

    def confirm(self, hmmidx: int, amino_seq: str):
        """Scanner confirmer contract: (logevalue, h3r_blob | None).

        Mirrors thread.c:188-205: logevalue = first hit's log e-value or
        log(1)=0 when there are no hits; clamp positives to 0; 0 means
        rejected (no product written).
        """
        result = self.get(hmmidx, amino_seq)
        if result.nhits == 0:
            return 0.0, None
        logevalue = min(result.hit_logevalue(0), 0.0)
        if logevalue == 0.0:
            return 0.0, None
        return logevalue, result.to_blob()
