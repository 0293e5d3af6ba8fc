"""Scheduler settings from DECIPHON_SCHED_* environment variables.

Parity: sched/deciphon_sched/settings.py (pydantic-settings env prefix);
implemented directly on os.environ to avoid the pydantic-settings
dependency.  The reference's S3/MQTT endpoints are replaced by the
built-in file store and job queue (see storage.py/journal.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

ENV_PREFIX = "DECIPHON_SCHED_"


def _env(name: str, default: str) -> str:
    return os.environ.get(ENV_PREFIX + name.upper(), default)


@dataclass
class SchedSettings:
    host: str = field(default_factory=lambda: _env("host", "127.0.0.1"))
    port: int = field(default_factory=lambda: int(_env("port", "49329")))
    data_dir: str = field(default_factory=lambda: _env(
        "data_dir", os.path.expanduser("~/.local/share/deciphon_tpu_torch/sched")))
    allow_any_origin: bool = field(default_factory=lambda: _env(
        "allow_any_origin", "false").lower() == "true")

    @property
    def db_path(self) -> str:
        return os.path.join(self.data_dir, "sched.sqlite3")

    @property
    def files_dir(self) -> str:
        return os.path.join(self.data_dir, "files")
