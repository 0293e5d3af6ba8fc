"""In-process daemons: press worker and scanner daemon.

Parity: worker/deciphon_worker — `press()` runs the press pipeline in a
thread with per-profile progress (press.py:12-32); `ScannerDaemon` owns a
request queue plus a worker thread, polling the scan progress on a 100 ms
cadence and honoring interrupts (scanner.py:38-110); `launch_scanner`
builds the daemon from a .dcp (and, when a paired .hmm and an hmmpgmd
launcher are available, wires the e-value confirmer — scanner.py:118-135).

The scanner daemon runs its Scanner on its own thread, inside the
Scanner's device: the card the Scanner was built for, not the thread's
default one.
"""

from __future__ import annotations

import contextlib
import os
import queue
import shutil
import threading
from dataclasses import dataclass

import torch

from ..io.dcp import read_dcp_profiles
from ..press import PressContext
from ..scan.pipeline import ScanConfig, Scanner
from ..scan.scheduler import canonical_device
from ..snap.snap_file import make_snap_archive
from .progressor import Progressor

__all__ = ["press", "PressWorker", "ScannerDaemon", "launch_scanner"]

POLL_SECONDS = 0.1  # worker/deciphon_worker/scanner.py Alarm cadence


def press(hmm_path: str, dcp_path: str | None = None, gencode_id: int = 1,
          epsilon: float = 0.01) -> Progressor:
    """Press in a background thread; returns a Progressor of the .dcp path."""
    prog = Progressor()

    if dcp_path is None:
        dcp_path = os.path.splitext(hmm_path)[0] + ".dcp"

    def work():
        try:
            with PressContext(hmm_path, dcp_path, gencode_id, epsilon) as ctx:
                for _ in range(ctx.nproteins):
                    prog.check_interrupted()
                    ctx.next()
                    prog.set_progress(100 * ctx.done // ctx.nproteins)
            prog.set_result(dcp_path)
        except BaseException as exc:
            prog.set_exception(exc)

    threading.Thread(target=work, daemon=True, name="press").start()
    return prog


class PressWorker:
    """Thin namespace mirroring the reference's worker.press module."""

    press = staticmethod(press)


@dataclass
class _ScanRequest:
    snap_path: str
    sequences: list
    progressor: Progressor


class ScannerDaemon:
    """Owns a Scanner and a request queue; one scan at a time.

    put() enqueues (snap_path, sequences) and returns a Progressor whose
    result is the .dcs path.  A monitor poll forwards Scanner.progress into
    the Progressor every POLL_SECONDS while the scan runs.  An interrupt
    ends the request with Interrupted (before the scan starts) or
    Scanner.Interrupted (between two of its waves); the daemon then serves
    the next request.
    """

    def __init__(self, scanner: Scanner):
        self.scanner = scanner
        # resolved here, on the thread that built the Scanner: a bare
        # "cuda" names that thread's current card
        self.device = canonical_device(scanner.device)
        self._queue: "queue.Queue[_ScanRequest | None]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="scanner-daemon")
        self._thread.start()

    def put(self, snap_path: str, sequences: list) -> Progressor:
        prog = Progressor()
        self._queue.put(_ScanRequest(snap_path, sequences, prog))
        return prog

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _run(self) -> None:
        on_device = (torch.cuda.device(self.device)
                     if self.device.type == "cuda"
                     else contextlib.nullcontext())
        with on_device:
            while True:
                req = self._queue.get()
                if req is None:
                    return
                self._serve(req)

    def _serve(self, req: _ScanRequest) -> None:
        prog = req.progressor
        stop = threading.Event()

        def poll():
            while not stop.wait(POLL_SECONDS):
                prog.set_progress(self.scanner.progress)

        monitor = threading.Thread(target=poll, daemon=True)
        monitor.start()
        try:
            prog.check_interrupted()
            base = os.path.splitext(os.path.basename(req.snap_path))[0]
            workdir = req.snap_path + ".work"
            basedir = os.path.join(workdir, base)
            os.makedirs(basedir, exist_ok=True)
            self.scanner.run(req.sequences, basedir,
                             should_stop=lambda: prog.interrupted)
            prog.check_interrupted()
            make_snap_archive(basedir, req.snap_path)
            shutil.rmtree(workdir, ignore_errors=True)
            prog.set_result(req.snap_path)
        except BaseException as exc:  # handed to the Progressor's reader
            prog.set_exception(exc)
        finally:
            stop.set()
            monitor.join()


def launch_scanner(dbfile: str, multi_hits: bool = True,
                   hmmer3_compat: bool = False, engine: str = "kernels",
                   hmmer_port: int | None = None,
                   device: str = "cuda") -> ScannerDaemon:
    """Build a ScannerDaemon from a pressed database, on `device` ("cuda",
    the default, or "cpu" when the caller asks for it) with ScanConfig's
    `engine`.

    When hmmer_port is given, hits are confirmed against a running hmmpgmd
    (the reference boots one via h3daemon from the paired .hmm,
    worker/scanner.py:118-135; here the daemon must already be running).
    """
    _, profiles = read_dcp_profiles(dbfile)
    confirmer = None
    if hmmer_port is not None:
        from ..hmmer.client import HMMERClient

        client = HMMERClient("127.0.0.1", hmmer_port,
                             num_proteins=len(profiles),
                             has_ga=all(p.has_ga for p in profiles))
        confirmer = client.confirm
    cfg = ScanConfig(multi_hits=multi_hits, hmmer3_compat=hmmer3_compat,
                     engine=engine, device=device)
    return ScannerDaemon(Scanner(profiles, cfg, confirmer=confirmer))
