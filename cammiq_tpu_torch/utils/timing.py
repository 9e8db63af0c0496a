"""Per-stage wall-clock timing, and the program's spans.

``stage_timer`` / ``Timings`` copy ``cammiq_tpu/utils/timing.py``: the
reference wraps every pipeline stage in chrono timers printed to stderr
(e.g. src/gsa.cpp:21-30, src/build.cpp:659-669, src/query.cpp:645-647),
and a stage timer is the structured equivalent, always timed, recorded
into a registry and optionally printed.

``span`` is the tracer, off by default.  While it is off a
span is one check that returns a shared no-op context manager: no clock is
read and nothing is allocated.  ``enable()`` / ``disable()`` or ``with
tracing():`` switch it; nothing else does (an active ``torch.profiler``
does not).  While it is on, a span records its name, its start and end on
``time.perf_counter_ns()``, its parent (the innermost span open around
it) and the read set it serves, which it inherits from its parent unless
given.  A span opened with ``fold=True`` (the per-batch ones) leaves no
record: its duration folds into its nearest unfolded ancestor's
``folded[name] = [count, total_ns, max_ns]``, so memory does not grow
with the number of batches.  While a ``torch.profiler`` is recording,
each span also opens a profiler range of its name (what
``torch.profiler.record_function`` opens, through its C++ form), so the
trace holds it as a host range on the profiler's clock, with its read set
as the range's ``read_set`` argument where the profiler records shapes.
``take()`` hands over what was recorded since the last take; its
``totals()`` sum the spans by name, of one read set if asked.

The tracer is one per process and expects its spans to be opened and
closed by one thread.  A stage timer is also a span, named ``span_name``
or the stage; ``Stages`` times back-to-back stages of one function as
spans without a block each.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time
from typing import Dict, List, Optional, Tuple


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


class Span:
    """One span while the tracer is on; after it closes, its record."""

    __slots__ = ("name", "read_set", "fold", "parent", "start_ns", "end_ns",
                 "folded", "_rf")

    def __init__(self, name: str, read_set: Optional[str], fold: bool):
        self.name = name
        self.read_set = read_set
        self.fold = fold
        self.folded: Dict[str, List[int]] = {}

    def __enter__(self) -> "Span":
        # torch only where the program imported it: the host build does not
        torch = sys.modules.get("torch")
        self._rf = None
        stack = TRACER.stack
        self.parent = stack[-1] if stack else None
        if self.read_set is None and self.parent is not None:
            self.read_set = self.parent.read_set
        if torch is not None and torch._C._autograd._profiler_enabled():
            # the profiler's named range in C++: about 2 us a range on the
            # host where record_function takes about 15, which at ~770
            # batch spans a sample would stretch the traced pass
            fast = torch._C._profiler._RecordFunctionFast
            self._rf = (fast(self.name) if self.read_set is None else
                        fast(self.name, (), {"read_set": self.read_set}))
            self._rf.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        stack = TRACER.stack
        while stack.pop() is not self:     # a stage an exception left open
            pass
        if not self.fold:
            TRACER.closed.append(self)
        else:
            owner = self.parent
            while owner is not None and owner.fold:
                owner = owner.parent
            _fold(owner.folded if owner is not None else TRACER.folded,
                  self.name, self.end_ns - self.start_ns)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def _fold(into: Dict[str, List[int]], name: str, ns: int) -> None:
    t = into.get(name)
    if t is None:
        into[name] = [1, ns, ns]
    else:
        t[0] += 1
        t[1] += ns
        t[2] = max(t[2], ns)


class Recorded:
    """What the tracer recorded between two takes: the closed unfolded
    spans (in the order they closed) and the folded spans that had no
    unfolded ancestor."""

    def __init__(self, spans: List[Span], folded: Dict[str, List[int]]):
        self.spans = spans
        self.folded = folded

    def totals(self, read_set: Optional[str] = None) -> Dict[str, List[int]]:
        """``{name: [count, total_ns, max_ns]}`` of every span, folded
        ones included; given ``read_set``, of the spans that served it."""
        out: Dict[str, List[int]] = {}
        if read_set is None:
            for name, (n, ns, mx) in self.folded.items():
                out[name] = [n, ns, mx]
        for s in self.spans:
            if read_set is not None and s.read_set != read_set:
                continue
            _fold(out, s.name, s.ns)
            for name, (n, ns, mx) in s.folded.items():
                t = out.setdefault(name, [0, 0, 0])
                t[0] += n
                t[1] += ns
                t[2] = max(t[2], mx)
        return out


class Tracer:
    __slots__ = ("on", "stack", "closed", "folded")

    def __init__(self) -> None:
        self.on = False
        self.stack: List[Span] = []
        self.closed: List[Span] = []
        self.folded: Dict[str, List[int]] = {}


TRACER = Tracer()
_NOOP = contextlib.nullcontext()


def span(name: str, read_set: Optional[str] = None, fold: bool = False):
    """A span named ``name`` around a block; the shared no-op while the
    tracer is off."""
    if not TRACER.on:
        return _NOOP
    return Span(name, read_set, fold)


def spanned(name: str):
    """Decorator: every call of the function in a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def enable() -> None:
    TRACER.on = True


def disable() -> None:
    TRACER.on = False


@contextlib.contextmanager
def tracing():
    """The tracer on for a block, then as it was."""
    was = TRACER.on
    TRACER.on = True
    try:
        yield
    finally:
        TRACER.on = was


def take() -> Recorded:
    """What was recorded since the last take, which the tracer forgets."""
    out = Recorded(TRACER.closed, TRACER.folded)
    TRACER.closed, TRACER.folded = [], {}
    return out


@contextlib.contextmanager
def stage_timer(stage: str, timings: Timings | None = None,
                verbose: bool = False, span_name: Optional[str] = None,
                read_set: Optional[str] = None):
    """Measure a pipeline stage into ``timings`` (reference-style 'Time for
    <x>: N ms.' where ``verbose``); also a span, named ``span_name`` or
    ``stage``."""
    t0 = time.perf_counter()
    try:
        with span(span_name or stage, read_set):
            yield
    finally:
        dt = time.perf_counter() - t0
        if timings is not None:
            timings.add(stage, dt)
        if verbose:
            print(f"Time for {stage}: {dt * 1e3:.0f} ms.", file=sys.stderr)


class Stages:
    """Back-to-back stages of one function, each the span
    ``<prefix><stage>``: ``begin(stage)`` ends the stage open and begins
    ``stage``, ``end()`` ends the last.  ``seconds`` holds each stage's
    seconds on ``time.perf_counter()``, the first counted from ``t0``."""

    def __init__(self, prefix: str, t0: float):
        self.prefix = prefix
        self.seconds: Dict[str, float] = {}
        self._t = t0
        self._open = None

    def begin(self, stage: str) -> None:
        self.end()
        self._open = (stage, span(self.prefix + stage))
        self._open[1].__enter__()

    def end(self) -> None:
        if self._open is not None:
            stage, s = self._open
            s.__exit__(None, None, None)
            t = time.perf_counter()
            self.seconds[stage] = t - self._t
            self._t = t
            self._open = None
