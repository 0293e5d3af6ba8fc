"""Artifact file store (S3-role replacement).

Parity target: sched/deciphon_sched/storage.py (boto3/S3 presigned
upload/download).  This backend keeps artifacts on the scheduler's disk
and the server exposes them at PUT/GET /files/{name}; the presigned-URL
endpoints return those URLs, so Poster's upload/download flow is
unchanged.  An S3 backend can be swapped in when boto3 exists.
"""

from __future__ import annotations

import os
import tempfile

__all__ = ["Storage"]


class Storage:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        base = os.path.basename(name)
        if not base or base != name:
            raise ValueError(f"invalid artifact name {name!r}")
        return os.path.join(self.root, base)

    def put(self, name: str, data: bytes) -> None:
        """Atomic write (temp file + rename, like the reference worker's
        atomic_file_creation, cli/deciphon/worker.py:45-53)."""
        path = self._path(name)
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".up_")
        try:
            with os.fdopen(fd, "wb") as fp:
                fp.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, name: str) -> bytes:
        with open(self._path(name), "rb") as fp:
            return fp.read()

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def delete(self, name: str) -> None:
        os.unlink(self._path(name))
