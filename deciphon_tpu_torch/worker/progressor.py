"""Progressor: a future with a progress stream and interrupt.

Parity: worker/deciphon_worker/progressor.py:9-51 — consumers iterate
`as_progress()` for 0-100 integers while the producer works; `result()`
blocks for the final value; `interrupt()` requests cancellation.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future

__all__ = ["Progressor", "Interrupted"]


class Interrupted(RuntimeError):
    pass


class Progressor:
    def __init__(self):
        self._future: Future = Future()
        self._cond = threading.Condition()
        self._progress = 0
        self._interrupted = threading.Event()

    # -- producer side -------------------------------------------------
    def set_progress(self, value: int) -> None:
        with self._cond:
            self._progress = max(0, min(100, int(value)))
            self._cond.notify_all()

    def set_result(self, value) -> None:
        self.set_progress(100)
        self._future.set_result(value)
        with self._cond:
            self._cond.notify_all()

    def set_exception(self, exc: BaseException) -> None:
        self._future.set_exception(exc)
        with self._cond:
            self._cond.notify_all()

    def check_interrupted(self) -> None:
        if self._interrupted.is_set():
            raise Interrupted("operation interrupted")

    # -- consumer side -------------------------------------------------
    @property
    def progress(self) -> int:
        with self._cond:
            return self._progress

    def interrupt(self) -> None:
        self._interrupted.set()
        with self._cond:
            self._cond.notify_all()

    @property
    def interrupted(self) -> bool:
        return self._interrupted.is_set()

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: float | None = None):
        return self._future.result(timeout)

    def exception(self, timeout: float | None = None):
        return self._future.exception(timeout)

    def as_progress(self):
        """Yield monotonically increasing progress values until done."""
        last = -1
        while True:
            with self._cond:
                if self._progress != last:
                    last = self._progress
                    yield last
                if self._future.done() and self._progress == last:
                    if last != 100 and self._future.exception() is None:
                        yield 100
                    return
                self._cond.wait(timeout=0.1)
