"""Interval coordinate types (parity: intervals/deciphon_intervals).

PyInterval: 0-start half-open; RInterval: 1-start fully-closed — the two
coordinate conventions used across products, GFF and alignment views
(reference intervals/deciphon_intervals/__init__.py:25-110).
"""

from __future__ import annotations

from pydantic import BaseModel, NonNegativeInt, PositiveInt, model_validator

__all__ = ["Interval", "PyInterval", "RInterval"]


class PyInterval(BaseModel):
    """0-start, half-open interval: coordinates start..stop-1."""

    start: NonNegativeInt
    stop: NonNegativeInt

    @model_validator(mode="after")
    def _check(self):
        assert self.start <= self.stop
        return self

    @property
    def r(self) -> "RInterval":
        return RInterval(start=self.start + 1, stop=self.stop)

    @property
    def py(self) -> "PyInterval":
        return self

    @property
    def slice(self) -> slice:
        return slice(self.start, self.stop)

    def offset(self, offset: int) -> "PyInterval":
        return PyInterval(start=self.start + offset, stop=self.stop + offset)


class RInterval(BaseModel):
    """1-start, fully-closed interval: coordinates start..stop."""

    start: PositiveInt
    stop: PositiveInt

    @model_validator(mode="after")
    def _check(self):
        assert self.start <= self.stop + 1
        return self

    @property
    def r(self) -> "RInterval":
        return self

    @property
    def py(self) -> PyInterval:
        return PyInterval(start=self.start - 1, stop=self.stop)

    @property
    def slice(self) -> slice:
        return self.py.slice

    def offset(self, offset: int) -> "RInterval":
        return RInterval(start=self.start + offset, stop=self.stop + offset)


Interval = PyInterval | RInterval
