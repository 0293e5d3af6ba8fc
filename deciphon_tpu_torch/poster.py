"""Poster: HTTP client of the scheduler (parity: poster/deciphon_poster).

Same endpoint coverage as the reference Poster (poster.py:16-120): hmm/db
CRUD with presigned upload/download, scan submission, job progress
updates, snap upload/download/views, plus the queue long-poll the workers
use (our journal's wire surface).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import requests

__all__ = ["Poster", "JobUpdate"]

TIMEOUT = 30.0


@dataclass
class JobUpdate:
    """Progress reporter bound to one job (poster schema.py:21-43)."""

    poster: "Poster"
    job_id: int

    def run(self, progress: int) -> None:
        self.poster.job_patch(self.job_id, "run", progress=progress)

    def done(self) -> None:
        self.poster.job_patch(self.job_id, "done")

    def fail(self, error: str) -> None:
        self.poster.job_patch(self.job_id, "fail", error=error)


class Poster:
    def __init__(self, url: str, session: requests.Session | None = None):
        self.url = url.rstrip("/")
        self.http = session or requests.Session()

    # -- plumbing ------------------------------------------------------
    def _req(self, method: str, path: str, ok=(200, 201, 204), **kw):
        kw.setdefault("timeout", TIMEOUT)
        r = self.http.request(method, f"{self.url}{path}", **kw)
        if r.status_code not in ok:
            raise RuntimeError(
                f"{method} {path} -> {r.status_code}: {r.text[:300]}")
        return r

    def handshake(self) -> dict:
        return self._req("GET", "/health").json()

    # -- artifacts -----------------------------------------------------
    def upload(self, kind: str, path: str, progress=None) -> None:
        """kind in {hmms, dbs}; presigned upload flow (poster.py:43-70)."""
        name = os.path.basename(path)
        pre = self._req("GET", f"/{kind}/presigned-upload/{name}").json()
        with open(path, "rb") as fp:
            data = fp.read()
        r = self.http.put(pre["url"], data=data, timeout=600)
        if r.status_code not in (200, 201, 204):
            raise RuntimeError(f"upload failed: {r.status_code}")
        if progress is not None:
            progress(len(data), len(data))

    def download(self, kind: str, name: str, dest: str) -> str:
        pre = self._req("GET", f"/{kind}/presigned-download/{name}").json()
        r = self.http.get(pre["url"], timeout=600)
        if r.status_code != 200:
            raise RuntimeError(f"download failed: {r.status_code}")
        tmp = dest + ".part"
        with open(tmp, "wb") as fp:
            fp.write(r.content)
        os.replace(tmp, dest)
        return dest

    # -- hmms / dbs ----------------------------------------------------
    def hmm_post(self, name: str, gencode: int, epsilon: float = 0.01):
        return self._req("POST", "/hmms/", json={
            "name": name, "gencode": gencode, "epsilon": epsilon}).json()

    def hmm_list(self):
        return self._req("GET", "/hmms").json()

    def hmm_get(self, hmm_id: int):
        return self._req("GET", f"/hmms/{hmm_id}").json()

    def hmm_delete(self, hmm_id: int) -> None:
        self._req("DELETE", f"/hmms/{hmm_id}")

    def db_post(self, name: str):
        return self._req("POST", "/dbs/", json={"name": name}).json()

    def db_list(self):
        return self._req("GET", "/dbs").json()

    def db_get(self, db_id: int):
        return self._req("GET", f"/dbs/{db_id}").json()

    def db_delete(self, db_id: int) -> None:
        self._req("DELETE", f"/dbs/{db_id}")

    # -- jobs ----------------------------------------------------------
    def job_list(self):
        return self._req("GET", "/jobs").json()

    def job_get(self, job_id: int):
        return self._req("GET", f"/jobs/{job_id}").json()

    def job_patch(self, job_id: int, state: str, progress: int = 0,
                  error: str = ""):
        return self._req("PATCH", f"/jobs/{job_id}", json={
            "state": state, "progress": progress, "error": error}).json()

    def job_update(self, job_id: int) -> JobUpdate:
        return JobUpdate(self, job_id)

    # -- scans / snaps -------------------------------------------------
    def scan_post(self, db_id: int, seqs: list[dict], multi_hits=True,
                  hmmer3_compat=False):
        return self._req("POST", "/scans/", json={
            "db_id": db_id, "multi_hits": multi_hits,
            "hmmer3_compat": hmmer3_compat, "seqs": seqs}).json()

    def scan_list(self, job_id: int | None = None):
        q = f"?job_id={job_id}" if job_id is not None else ""
        return self._req("GET", f"/scans{q}").json()

    def scan_get(self, scan_id: int):
        return self._req("GET", f"/scans/{scan_id}").json()

    def scan_delete(self, scan_id: int) -> None:
        self._req("DELETE", f"/scans/{scan_id}")

    def snap_post(self, scan_id: int, dcs_path: str):
        with open(dcs_path, "rb") as fp:
            data = fp.read()
        return self._req("POST", f"/scans/{scan_id}/snap.dcs",
                         data=data).json()

    def snap_get(self, scan_id: int) -> bytes:
        return self._req("GET", f"/scans/{scan_id}/snap.dcs").content

    def snap_delete(self, scan_id: int) -> None:
        self._req("DELETE", f"/scans/{scan_id}/snap.dcs")

    def snap_view(self, scan_id: int, kind: str = "view") -> str:
        r = self._req("GET", f"/scans/{scan_id}/snap.dcs/{kind}")
        return r.text if kind in ("gff", "view", "queries", "states",
                                  "codons", "aminos") else r.json()

    def seq_list(self):
        return self._req("GET", "/seqs").json()

    # -- worker queue --------------------------------------------------
    def queue_next(self, topic: str, timeout: float = 5.0):
        r = self._req("GET", f"/queue/{topic}?timeout={timeout}",
                      ok=(200, 204), timeout=timeout + TIMEOUT)
        if r.status_code == 204:
            return None
        return r.json()
