"""Daemon management: launch a real hmmpgmd, or serve the fake for tests.

Parity target: the reference's h3daemon package boots `hmmpgmd --master`
on the pressed .hmm (worker/hmmer.py:15-36 + h3daemon start_daemon.sh).
`launch_hmmpgmd` does the same when HMMER binaries exist on PATH (they do
not in this build environment, so it raises a clear error otherwise).

`FakeHMMERDaemon` speaks the same socket framing as hmmer/client.py and
answers every query from a NativeConfirmer-style scorer; it backs the
client tests and offers a fully in-process confirmation service.
"""

from __future__ import annotations

import shutil
import socket
import struct
import subprocess
import threading
import time

from .client import STATUS_FMT, recv_exact
from .h3result import H3Result
from .wire import serialize_reply

__all__ = ["launch_hmmpgmd", "FakeHMMERDaemon"]


def launch_hmmpgmd(hmmfile: str, port: int,
                   wait_seconds: float = 10.0) -> subprocess.Popen:
    """Start `hmmpgmd --master --hmmdb HMMFILE --cport PORT` and wait for
    the port (requires hmmpress side files, like the reference's press
    stage runs via `hmmpress -f`, cli/deciphon/hmmer_press.py)."""
    if shutil.which("hmmpgmd") is None:
        raise RuntimeError(
            "hmmpgmd not found on PATH; install HMMER3 or use the native "
            "confirmer (deciphon_tpu.hmmer.NativeConfirmer)")
    proc = subprocess.Popen(
        ["hmmpgmd", "--master", "--hmmdb", hmmfile, "--cport", str(port)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.time() + wait_seconds
    while time.time() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1.0):
                return proc
        except OSError:
            time.sleep(0.1)
    proc.terminate()
    raise RuntimeError(f"hmmpgmd did not open port {port}")


class FakeHMMERDaemon:
    """In-process socket daemon answering hmmpgmd-framed queries.

    `responder(hmmidx, seq) -> H3Result` supplies the answers (e.g. a
    NativeConfirmer's scorer, or canned results in tests).
    """

    def __init__(self, responder, host: str = "127.0.0.1", port: int = 0):
        self.responder = responder
        self._server = socket.create_server((host, port))
        self.port = self._server.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        try:
            self._server.close()
        except OSError:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _serve(self) -> None:
        self._server.settimeout(0.2)
        conns: list[threading.Thread] = []
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except (socket.timeout, OSError):
                continue
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            conns.append(t)

    def _handle(self, conn: socket.socket) -> None:
        conn.settimeout(60)
        try:
            buf = b""
            while not self._stop.is_set():
                while b"//" not in buf:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                request, _, buf = buf.partition(b"//")
                self._answer(conn, request.decode())
        except OSError:
            return
        finally:
            conn.close()

    def _answer(self, conn: socket.socket, request: str) -> None:
        lines = [x for x in request.splitlines() if x.strip()]
        cmd = lines[0]
        assert cmd.startswith("@"), cmd
        seq = "".join(x for x in lines[1:] if not x.startswith(">"))
        hmmidx = 0
        for tok in cmd.split():
            if tok.startswith("--hmmdb_range"):
                continue
            if ".." in tok:
                hmmidx = int(tok.split("..")[0])
        try:
            result = self.responder(hmmidx, seq)
            msg = serialize_reply(result)  # real hmmpgmd wire format
            conn.sendall(struct.pack(STATUS_FMT, 0, len(msg)) + msg)
        except Exception as exc:  # report as daemon error status
            msg = str(exc).encode()
            conn.sendall(struct.pack(STATUS_FMT, 1, len(msg)) + msg)
