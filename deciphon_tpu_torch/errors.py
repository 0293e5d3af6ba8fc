"""Unified error taxonomy (parity: c-core/error.c's 80-code table +
deciphon.h:34-117, python-core/deciphon_core/error.py DeciphonError).

The framework raises ordinary typed exceptions; this module gives every
public error family a stable integer code and a single lookup, so API
layers (REST, CLI exit codes, workers reporting job failures) can speak
the same contract the reference's numeric error table provided.
"""

from __future__ import annotations

__all__ = ["DeciphonTPUError", "error_code", "error_string", "wrap"]


class DeciphonTPUError(RuntimeError):
    """Base class carrying a stable numeric code."""

    code = 1

    def __init__(self, message: str = ""):
        super().__init__(message or self.__doc__ or type(self).__name__)


def _codes():
    from .alphabet import InvalidSequenceError, MixedTUError
    from .hmmfile import HMMFileError
    from .io.dcp import DcpFormatError
    from .hmmer.client import HMMERError
    from .sched.database import JobStateTransitionError, NotFoundError
    from .worker.progressor import Interrupted

    return {
        # engine tier
        HMMFileError: 10,          # malformed .hmm (DCP_EFREAD family)
        DcpFormatError: 11,        # malformed .dcp (DCP_EFDATA family)
        InvalidSequenceError: 12,  # bad nucleotide symbol (DCP_ESEQABC)
        MixedTUError: 13,          # T and U mixed (DCP_ENUCLTSEQTU)
        # confirmation tier
        HMMERError: 20,            # hmmpgmd dial/put/pop (DCP_EH3C*)
        # orchestration tier
        Interrupted: 30,           # user interrupt (DCP_EENDED family)
        # services tier
        NotFoundError: 40,
        JobStateTransitionError: 41,
        ValueError: 2,
        FileNotFoundError: 3,
    }


def error_code(exc: BaseException) -> int:
    """Stable numeric code for an exception (0 means success/no error)."""
    if isinstance(exc, DeciphonTPUError):
        return exc.code
    for cls, code in _codes().items():
        if isinstance(exc, cls):
            return code
    return 1  # unknown error


def error_string(code: int) -> str:
    """Code -> short family name (dcp_error_string parity)."""
    names = {
        0: "ok", 1: "unknown error", 2: "invalid value",
        3: "file not found",
        10: "malformed profile file", 11: "malformed database file",
        12: "invalid sequence symbol", 13: "sequence mixes T and U",
        20: "hmmer daemon failure", 30: "interrupted",
        40: "entity not found", 41: "illegal job state transition",
    }
    return names.get(code, f"error {code}")


def wrap(exc: BaseException) -> tuple[int, str]:
    """(code, message) pair for reporting an exception upstream."""
    return error_code(exc), f"{error_string(error_code(exc))}: {exc}"
