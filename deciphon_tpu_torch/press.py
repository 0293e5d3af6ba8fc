"""Press pipeline: .hmm -> .dcp (reference: c-core/press.c, dcp_press_*).

Fixed config mirroring dcp_press_setup (press.c:55-65): DNA alphabet,
IUPAC amino, entry_dist = occupancy; gencode id + epsilon are caller args.
has_ga is the AND over all profiles' GA lines (press.c:50,184).

The per-profile hot loop — the 1364-entry emission tables for K+1 nodes
(protein_absorb's OpenMP loop, c-core/protein.c:95-104) — is dense
vectorized table math in profile.press_profile (frame.emission_table), so
no explicit parallelism is needed; a process pool would only add IPC cost.
"""

from __future__ import annotations

from dataclasses import dataclass

from .hmmfile import count_profiles, iter_hmm
from .io.dcp import DcpWriter
from .profile import ENTRY_DIST_OCCUPANCY, press_profile


@dataclass
class PressStats:
    num_proteins: int = 0
    done: int = 0


class PressContext:
    """Streaming press: open -> next() per profile -> close.

    API parity: python-core/deciphon_core/press.py PressContext.
    """

    def __init__(self, hmm_path: str, dcp_path: str, gencode_id: int,
                 epsilon: float = 0.01):
        self.hmm_path = str(hmm_path)
        self.dcp_path = str(dcp_path)
        self.gencode_id = gencode_id
        self.epsilon = float(epsilon)
        self.nproteins = count_profiles(self.hmm_path)
        if self.nproteins == 0:
            raise ValueError(
                f"{self.hmm_path}: no HMMER3/f profiles found")
        self._fp = open(self.hmm_path, "rt")
        self._profiles = iter_hmm(self._fp)
        self._writer = DcpWriter(self.dcp_path, ENTRY_DIST_OCCUPANCY,
                                 self.epsilon)
        self._has_ga = True
        self._done = 0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self._fp.close()

    @property
    def done(self) -> int:
        return self._done

    def next(self) -> str:
        """Press one profile; returns its accession."""
        hmm = next(self._profiles)
        prof = press_profile(hmm, self.gencode_id, self.epsilon)
        if not prof.has_ga:
            self._has_ga = False
        self._writer.pack_profile(prof)
        self._done += 1
        return prof.accession

    def close(self) -> str:
        self._fp.close()
        self._writer.set_has_ga(self._has_ga)
        return self._writer.close()


def press(hmm_path: str, dcp_path: str | None = None, gencode_id: int = 1,
          epsilon: float = 0.01, progress=None) -> str:
    """Press a whole file; returns the .dcp path.

    progress, if given, is called with (done, total) after each profile
    (the Progressor contract, worker/deciphon_worker/press.py:12-32).
    """
    if dcp_path is None:
        if not hmm_path.endswith(".hmm"):
            raise ValueError("cannot derive .dcp name: input is not *.hmm")
        dcp_path = hmm_path[:-4] + ".dcp"
    with PressContext(hmm_path, dcp_path, gencode_id, epsilon) as ctx:
        for _ in range(ctx.nproteins):
            ctx.next()
            if progress is not None:
                progress(ctx.done, ctx.nproteins)
    return dcp_path
