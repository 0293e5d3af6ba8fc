"""Shared pydantic models: file-name algebra, gencodes, job/scan DTOs.

Parity: schema/deciphon_schema/__init__.py — the `.hmm -> .dcp -> .dcs`
suffix algebra, NCBI Gencode enum, and the DTOs exchanged between the
scheduler service, workers and control CLI.
"""

from __future__ import annotations

import shutil
from datetime import datetime
from enum import Enum, IntEnum
from pathlib import Path
from typing import Optional

from pydantic import BaseModel, Field, FilePath, field_validator

__all__ = [
    "NAME_MAX_LENGTH", "HMM_NAME_PATTERN", "DB_NAME_PATTERN",
    "SNAP_NAME_PATTERN", "HMMName", "DBName", "SnapName", "HMMPath",
    "DBPath", "SnapPath", "HMMFile", "DBFile", "SnapFile", "NewHMMFile",
    "NewDBFile", "NewSnapFile", "Gencode", "JobType", "JobState", "JobRead",
    "PressRequest", "ScanRequest", "HMMRead", "DBRead", "SeqRead",
    "SnapRead", "ScanRead", "ProdRead",
]

NAME_MAX_LENGTH = 128


def _name_pattern(ext: str) -> str:
    return r"^[0-9a-zA-Z_\-.][0-9a-zA-Z_\-. ]+\." + ext + "$"


HMM_NAME_PATTERN = _name_pattern("hmm")
DB_NAME_PATTERN = _name_pattern("dcp")
SNAP_NAME_PATTERN = _name_pattern("dcs")


# --------------------------------------------------------------------------
# Names (basename-level) and paths, with suffix conversions
# --------------------------------------------------------------------------


class HMMName(BaseModel):
    name: str = Field(pattern=HMM_NAME_PATTERN, max_length=NAME_MAX_LENGTH)

    @property
    def dbname(self) -> "DBName":
        return DBName(name=self.name[:-4] + ".dcp")


class DBName(BaseModel):
    name: str = Field(pattern=DB_NAME_PATTERN, max_length=NAME_MAX_LENGTH)

    @property
    def hmmname(self) -> HMMName:
        return HMMName(name=self.name[:-4] + ".hmm")


class SnapName(BaseModel):
    name: str = Field(pattern=SNAP_NAME_PATTERN, max_length=NAME_MAX_LENGTH)


def _check_suffix(path: Path, suffix: str) -> Path:
    if path.suffix != suffix:
        raise ValueError(f"must end in `{suffix}`")
    return path


class HMMPath(BaseModel):
    path: Path

    @field_validator("path")
    @classmethod
    def _suffix(cls, x: Path):
        return _check_suffix(x, ".hmm")

    @property
    def dbpath(self) -> "DBPath":
        return DBPath(path=self.path.with_suffix(".dcp"))


class DBPath(BaseModel):
    path: Path

    @field_validator("path")
    @classmethod
    def _suffix(cls, x: Path):
        return _check_suffix(x, ".dcp")

    @property
    def hmmpath(self) -> HMMPath:
        return HMMPath(path=self.path.with_suffix(".hmm"))


class SnapPath(BaseModel):
    path: Path

    @field_validator("path")
    @classmethod
    def _suffix(cls, x: Path):
        return _check_suffix(x, ".dcs")


class HMMFile(BaseModel):
    """An existing .hmm file."""

    path: FilePath

    @field_validator("path")
    @classmethod
    def _suffix(cls, x: Path):
        return _check_suffix(x, ".hmm")

    @property
    def dbfile(self) -> "DBPath":
        return DBPath(path=self.path.with_suffix(".dcp"))


class DBFile(BaseModel):
    """An existing .dcp file."""

    path: FilePath

    @field_validator("path")
    @classmethod
    def _suffix(cls, x: Path):
        return _check_suffix(x, ".dcp")


class SnapFile(BaseModel):
    """An existing .dcs file."""

    path: FilePath

    @field_validator("path")
    @classmethod
    def _suffix(cls, x: Path):
        return _check_suffix(x, ".dcs")


class NewHMMFile(BaseModel):
    """A .hmm path that must not exist yet."""

    path: Path

    @field_validator("path")
    @classmethod
    def _check(cls, x: Path):
        _check_suffix(x, ".hmm")
        if x.exists():
            raise ValueError(f"`{x}` already exists")
        return x


class NewDBFile(BaseModel):
    """A .dcp path that must not exist yet."""

    path: Path

    @field_validator("path")
    @classmethod
    def _check(cls, x: Path):
        _check_suffix(x, ".dcp")
        if x.exists():
            raise ValueError(f"`{x}` already exists")
        return x


class NewSnapFile(BaseModel):
    """A .dcs path to be produced from its base directory.

    The reference deletes a pre-existing snap and refuses an existing
    basedir (schema/__init__.py:200-226); make_archive zips basedir into
    the final .dcs.
    """

    path: Path

    @field_validator("path")
    @classmethod
    def _check(cls, x: Path):
        _check_suffix(x, ".dcs")
        if x.exists():
            x.unlink()
        if x.with_suffix("").exists():
            raise ValueError(f"`{x.with_suffix('')}` path must not exist")
        return x

    @property
    def basedir(self) -> Path:
        return self.path.with_suffix("")

    def make_archive(self) -> SnapFile:
        basedir = self.basedir
        made = shutil.make_archive(str(basedir), "zip", self.path.parent,
                                   basedir.name)
        shutil.move(made, self.path)
        shutil.rmtree(basedir)
        return SnapFile(path=self.path)


# --------------------------------------------------------------------------
# Gencodes
# --------------------------------------------------------------------------


class Gencode(IntEnum):
    """NCBI genetic-code ids (27 codes; schema/__init__.py:229-264)."""

    SGC0 = 1
    SGC1 = 2
    SGC2 = 3
    SGC3 = 4
    SGC4 = 5
    SGC5 = 6
    SGC8 = 9
    SGC9 = 10
    BAPP = 11
    AYN = 12
    AMC = 13
    AFMC = 14
    BMN = 15
    CMC = 16
    TMC = 21
    SOMC = 22
    TMMC = 23
    PMMC = 24
    CDSR1G = 25
    PTN = 26
    KN = 27
    CN = 28
    MN = 29
    PN = 30
    BN = 31
    BP = 32
    CMMC = 33

    def __str__(self):
        return str(self.value)


# --------------------------------------------------------------------------
# Job / scan DTOs
# --------------------------------------------------------------------------


class JobType(Enum):
    hmm = "hmm"
    scan = "scan"


class JobState(Enum):
    pend = "pend"
    run = "run"
    done = "done"
    fail = "fail"


class JobRead(BaseModel):
    id: int
    type: JobType
    state: JobState
    progress: int
    error: str
    submission: datetime
    exec_started: Optional[datetime] = None
    exec_ended: Optional[datetime] = None


class SeqRead(BaseModel):
    id: int
    name: str
    data: str


class PressRequest(BaseModel):
    job_id: int
    hmm: HMMName
    db: DBName
    gencode: Gencode
    epsilon: float

    @classmethod
    def create(cls, job_id: int, hmm: HMMName, gencode: Gencode,
               epsilon: float) -> "PressRequest":
        return cls(job_id=job_id, hmm=hmm, db=hmm.dbname, gencode=gencode,
                   epsilon=epsilon)


class HMMRead(BaseModel):
    id: int
    job: JobRead
    file: HMMName


class DBRead(BaseModel):
    id: int
    hmm: HMMRead
    file: DBName


class SnapRead(BaseModel):
    id: int
    size: int


class ScanRead(BaseModel):
    id: int
    job: JobRead
    db: DBRead
    multi_hits: bool
    hmmer3_compat: bool
    seqs: list[SeqRead]


class ScanRequest(BaseModel):
    id: int
    job_id: int
    hmm: HMMName
    db: DBName
    multi_hits: bool
    hmmer3_compat: bool
    seqs: list[SeqRead]

    @classmethod
    def create(cls, scan: ScanRead) -> "ScanRequest":
        return cls(id=scan.id, job_id=scan.job.id,
                   hmm=HMMName(name=scan.db.file.hmmname.name),
                   db=scan.db.file, multi_hits=scan.multi_hits,
                   hmmer3_compat=scan.hmmer3_compat, seqs=scan.seqs)


class ProdRead(BaseModel):
    seq_id: int
    profile: str
    abc: str
    lrt: float
    evalue: float
