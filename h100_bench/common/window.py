"""What a run measured, as the metric readers see it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from h100_bench.common.trace import Trace


@dataclass
class Job:
    index: int  # the input file's
    start: float  # host clock, seconds
    end: float
    in_bytes: int
    out_bytes: int
    error: Optional[str] = None  # what the entry raised, if it did
    same: Optional[bool] = None  # None: kept; else equal to the kept stream
    overflow: bool = False


@dataclass
class Window:
    start: float  # host clock, seconds
    jobs: List[Job]
    setup_s: float
    stages: dict  # the program's stage_stats over the window
    trace: Optional[Trace] = None  # the traced run's

    @property
    def seconds(self) -> float:
        return self.jobs[-1].end - self.start
