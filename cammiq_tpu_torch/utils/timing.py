"""Per-stage wall-clock tracing: a copy of ``cammiq_tpu/utils/timing.py``.

The reference wraps every pipeline stage in chrono timers printed to stderr
(e.g. src/gsa.cpp:21-30, src/build.cpp:659-669, src/query.cpp:645-647).
This module is the structured equivalent: a context manager that records
stage durations into a registry and optionally logs them.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Tuple


class Timings:
    """A registry of (stage, seconds) measurements."""

    def __init__(self) -> None:
        self.records: List[Tuple[str, float]] = []

    def add(self, stage: str, seconds: float) -> None:
        self.records.append((stage, seconds))

    def total(self) -> float:
        return sum(s for _, s in self.records)

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for stage, sec in self.records:
            out[stage] = out.get(stage, 0.0) + sec
        return out

    def report(self, file=sys.stderr) -> None:
        for stage, sec in self.records:
            print(f"Time for {stage}: {sec * 1e3:.0f} ms.", file=file)


GLOBAL_TIMINGS = Timings()


@contextlib.contextmanager
def stage_timer(stage: str, timings: Timings | None = None, verbose: bool = False):
    """Measure a pipeline stage (reference-style 'Time for <x>: N ms.')."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        (timings or GLOBAL_TIMINGS).add(stage, dt)
        if verbose:
            print(f"Time for {stage}: {dt * 1e3:.0f} ms.", file=sys.stderr)
