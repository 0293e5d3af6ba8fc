"""Scheduler state: sqlite3-backed jobs/hmms/dbs/scans/seqs/snaps.

Parity: sched/deciphon_sched/sched/models.py — same entities, same job
state machine (pend -> run -> done|fail with illegal-transition errors,
models.py:70-97), same read DTOs (deciphon_tpu.schema).  SQLAlchemy is
not available in this environment; plain sqlite3 with WAL and a lock
serves the same single-node role.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from datetime import datetime, timezone

from ..schema import (DBName, DBRead, HMMName, HMMRead, JobRead, JobState,
                      JobType, ScanRead, SeqRead, SnapRead)

__all__ = ["Database", "NotFoundError", "JobStateTransitionError"]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS job (
  id INTEGER PRIMARY KEY,
  type TEXT NOT NULL,
  state TEXT NOT NULL,
  progress INTEGER NOT NULL,
  error TEXT NOT NULL,
  submission TEXT NOT NULL,
  exec_started TEXT,
  exec_ended TEXT
);
CREATE TABLE IF NOT EXISTS hmm (
  id INTEGER PRIMARY KEY,
  job_id INTEGER NOT NULL REFERENCES job(id) ON DELETE CASCADE,
  name TEXT NOT NULL UNIQUE
);
CREATE TABLE IF NOT EXISTS db (
  id INTEGER PRIMARY KEY,
  hmm_id INTEGER NOT NULL REFERENCES hmm(id) ON DELETE CASCADE,
  name TEXT NOT NULL UNIQUE
);
CREATE TABLE IF NOT EXISTS scan (
  id INTEGER PRIMARY KEY,
  job_id INTEGER NOT NULL REFERENCES job(id) ON DELETE CASCADE,
  db_id INTEGER NOT NULL REFERENCES db(id) ON DELETE CASCADE,
  multi_hits INTEGER NOT NULL,
  hmmer3_compat INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS seq (
  id INTEGER PRIMARY KEY,
  scan_id INTEGER NOT NULL REFERENCES scan(id) ON DELETE CASCADE,
  name TEXT NOT NULL,
  data TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS snap (
  id INTEGER PRIMARY KEY,
  scan_id INTEGER NOT NULL UNIQUE REFERENCES scan(id) ON DELETE CASCADE,
  data BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS queue (
  id INTEGER PRIMARY KEY,
  topic TEXT NOT NULL,
  payload TEXT NOT NULL,
  claimed INTEGER NOT NULL DEFAULT 0
);
"""


class NotFoundError(KeyError):
    pass


class JobStateTransitionError(RuntimeError):
    def __init__(self, src: str, dst: str):
        super().__init__(f"illegal job state transition {src} -> {dst}")


def _now() -> str:
    return datetime.now(timezone.utc).isoformat()


class Database:
    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._conn.executescript(_SCHEMA)
        self._lock = threading.RLock()

    def close(self):
        self._conn.close()

    # -- jobs ----------------------------------------------------------
    def create_job(self, type_: JobType) -> int:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "INSERT INTO job (type, state, progress, error, submission)"
                " VALUES (?, 'pend', 0, '', ?)", (type_.value, _now()))
            return cur.lastrowid

    def job_read(self, job_id: int) -> JobRead:
        row = self._one("SELECT * FROM job WHERE id=?", (job_id,), "job")
        return JobRead(
            id=row["id"], type=JobType(row["type"]),
            state=JobState(row["state"]), progress=row["progress"],
            error=row["error"], submission=row["submission"],
            exec_started=row["exec_started"], exec_ended=row["exec_ended"])

    def jobs(self) -> list[JobRead]:
        ids = [r["id"] for r in self._conn.execute("SELECT id FROM job")]
        return [self.job_read(i) for i in ids]

    def job_patch(self, job_id: int, state: JobState, progress: int = 0,
                  error: str = "") -> JobRead:
        with self._lock, self._conn:
            row = self._one("SELECT * FROM job WHERE id=?", (job_id,), "job")
            cur_state = JobState(row["state"])
            if cur_state in (JobState.done, JobState.fail):
                raise JobStateTransitionError(cur_state.value, state.value)
            if state == JobState.pend:
                raise JobStateTransitionError(cur_state.value, state.value)
            started = row["exec_started"] or _now()
            if state == JobState.run:
                self._conn.execute(
                    "UPDATE job SET state='run', progress=?, exec_started=?"
                    " WHERE id=?", (progress, started, job_id))
            elif state == JobState.done:
                self._conn.execute(
                    "UPDATE job SET state='done', progress=100,"
                    " exec_started=?, exec_ended=? WHERE id=?",
                    (started, _now(), job_id))
            else:  # fail
                self._conn.execute(
                    "UPDATE job SET state='fail', error=?, exec_started=?,"
                    " exec_ended=? WHERE id=?",
                    (error, started, _now(), job_id))
        return self.job_read(job_id)

    # -- hmms / dbs ----------------------------------------------------
    def create_hmm(self, name: str) -> HMMRead:
        with self._lock, self._conn:
            job_id = self.create_job(JobType.hmm)
            cur = self._conn.execute(
                "INSERT INTO hmm (job_id, name) VALUES (?, ?)",
                (job_id, name))
            return self.hmm_read(cur.lastrowid)

    def hmm_read(self, hmm_id: int) -> HMMRead:
        row = self._one("SELECT * FROM hmm WHERE id=?", (hmm_id,), "HMM")
        return HMMRead(id=row["id"], job=self.job_read(row["job_id"]),
                       file=HMMName(name=row["name"]))

    def hmms(self) -> list[HMMRead]:
        ids = [r["id"] for r in self._conn.execute("SELECT id FROM hmm")]
        return [self.hmm_read(i) for i in ids]

    def hmm_by_name(self, name: str) -> HMMRead:
        row = self._one("SELECT * FROM hmm WHERE name=?", (name,), "HMM")
        return self.hmm_read(row["id"])

    def delete_hmm(self, hmm_id: int) -> None:
        self._delete("hmm", hmm_id)

    def create_db(self, name: str) -> DBRead:
        hmm = self.hmm_by_name(name[:-4] + ".hmm")
        with self._lock, self._conn:
            cur = self._conn.execute(
                "INSERT INTO db (hmm_id, name) VALUES (?, ?)",
                (hmm.id, name))
            return self.db_read(cur.lastrowid)

    def db_read(self, db_id: int) -> DBRead:
        row = self._one("SELECT * FROM db WHERE id=?", (db_id,), "DB")
        return DBRead(id=row["id"], hmm=self.hmm_read(row["hmm_id"]),
                      file=DBName(name=row["name"]))

    def dbs(self) -> list[DBRead]:
        ids = [r["id"] for r in self._conn.execute("SELECT id FROM db")]
        return [self.db_read(i) for i in ids]

    def delete_db(self, db_id: int) -> None:
        self._delete("db", db_id)

    # -- scans / seqs / snaps ------------------------------------------
    def create_scan(self, db_id: int, multi_hits: bool, hmmer3_compat: bool,
                    seqs: list[tuple[str, str]]) -> ScanRead:
        self.db_read(db_id)  # existence check
        with self._lock, self._conn:
            job_id = self.create_job(JobType.scan)
            cur = self._conn.execute(
                "INSERT INTO scan (job_id, db_id, multi_hits, hmmer3_compat)"
                " VALUES (?, ?, ?, ?)",
                (job_id, db_id, int(multi_hits), int(hmmer3_compat)))
            scan_id = cur.lastrowid
            for name, data in seqs:
                self._conn.execute(
                    "INSERT INTO seq (scan_id, name, data) VALUES (?, ?, ?)",
                    (scan_id, name, data))
            return self.scan_read(scan_id)

    def scan_read(self, scan_id: int) -> ScanRead:
        row = self._one("SELECT * FROM scan WHERE id=?", (scan_id,), "Scan")
        seqs = [SeqRead(id=r["id"], name=r["name"], data=r["data"])
                for r in self._conn.execute(
                    "SELECT * FROM seq WHERE scan_id=?", (scan_id,))]
        return ScanRead(id=row["id"], job=self.job_read(row["job_id"]),
                        db=self.db_read(row["db_id"]),
                        multi_hits=bool(row["multi_hits"]),
                        hmmer3_compat=bool(row["hmmer3_compat"]), seqs=seqs)

    def scans(self, job_id: int | None = None) -> list[ScanRead]:
        if job_id is None:
            rows = self._conn.execute("SELECT id FROM scan")
        else:
            rows = self._conn.execute("SELECT id FROM scan WHERE job_id=?",
                                      (job_id,))
        return [self.scan_read(r["id"]) for r in rows]

    def delete_scan(self, scan_id: int) -> None:
        self._delete("scan", scan_id)

    def seqs(self) -> list[SeqRead]:
        return [SeqRead(id=r["id"], name=r["name"], data=r["data"])
                for r in self._conn.execute("SELECT * FROM seq")]

    def seq_read(self, seq_id: int) -> SeqRead:
        r = self._one("SELECT * FROM seq WHERE id=?", (seq_id,), "Seq")
        return SeqRead(id=r["id"], name=r["name"], data=r["data"])

    def put_snap(self, scan_id: int, data: bytes) -> SnapRead:
        self.scan_read(scan_id)
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO snap (scan_id, data) VALUES (?, ?)",
                (scan_id, data))
        return self.snap_read(scan_id)

    def snap_read(self, scan_id: int) -> SnapRead:
        row = self._one("SELECT id, length(data) AS size FROM snap"
                        " WHERE scan_id=?", (scan_id,), "Snap")
        return SnapRead(id=row["id"], size=row["size"])

    def snap_data(self, scan_id: int) -> bytes:
        row = self._one("SELECT data FROM snap WHERE scan_id=?", (scan_id,),
                        "Snap")
        return row["data"]

    def delete_snap(self, scan_id: int) -> None:
        with self._lock, self._conn:
            cur = self._conn.execute("DELETE FROM snap WHERE scan_id=?",
                                     (scan_id,))
            if cur.rowcount == 0:
                raise NotFoundError("Snap not found")

    # -- job queue (journal backend) -----------------------------------
    def queue_publish(self, topic: str, payload: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO queue (topic, payload) VALUES (?, ?)",
                (topic, payload))

    def queue_claim(self, topic: str) -> str | None:
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT id, payload FROM queue WHERE topic=? AND claimed=0"
                " ORDER BY id LIMIT 1", (topic,)).fetchone()
            if row is None:
                return None
            self._conn.execute("UPDATE queue SET claimed=1 WHERE id=?",
                               (row["id"],))
            return row["payload"]

    # ------------------------------------------------------------------
    def _one(self, sql: str, args: tuple, what: str) -> sqlite3.Row:
        row = self._conn.execute(sql, args).fetchone()
        if row is None:
            raise NotFoundError(f"{what} not found")
        return row

    def _delete(self, table: str, id_: int) -> None:
        assert table in ("hmm", "db", "scan")
        with self._lock, self._conn:
            cur = self._conn.execute(f"DELETE FROM {table} WHERE id=?",
                                     (id_,))
            if cur.rowcount == 0:
                raise NotFoundError(f"{table} not found")
