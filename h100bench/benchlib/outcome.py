"""What a driver hands back to ``run.py``: the end-to-end readings, the
observations the per-layer readers read, the numbers compared with their
limits, and the run's counts."""

from __future__ import annotations

import dataclasses

__all__ = ["Check", "Outcome", "Context"]


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    upper: bool = True  # the value may not exceed the limit (else: fall below it)

    @property
    def ok(self) -> bool:
        # A value that is not a number (NaN) passes neither way.
        return self.value <= self.limit if self.upper else self.value >= self.limit

    def line(self) -> str:
        return f"{self.name} {self.value!r} {'<=' if self.upper else '>='} {self.limit!r}"


@dataclasses.dataclass
class Outcome:
    e2e: dict
    obs: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    info: list = dataclasses.field(default_factory=list)
    trace: object = None  # benchlib.trace.TraceReading of the traced window

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0


@dataclasses.dataclass
class Context:
    """A run's inputs. ``device`` is "cuda" in a benchmark run; the CPU tests
    pass "cpu" and a tiny configuration. ``fault`` (tests only) breaks the
    timed path underneath once the program is built. ``controls`` names
    reference precisions to read beside the reference (the control script)."""

    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    fault: object = None
    controls: tuple = ()
