"""The device trace of one traced sample, and the arithmetic on it.

``device_busy(fn)`` runs ``fn`` under the device's activity alone and
returns its device-busy seconds (the window's ``device_ms_per_mread``).
``traced(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) and returns a ``Trace``: every device operation (kernels,
copies, memsets) with its start and end, and the host's ranges.  The sums
by name and the operation count are those of
``cammiq_tpu_torch/tools/pass_bench.py:profile_pass`` (its self device
time and count of each device event, copied); the busy time is the union
of the device operations' intervals, and the idle gaps are the stretches
between them, named by what the host was doing: the innermost of the
benchmark's own ranges (``pb.*``) and the innermost host operation that
covers the gap's middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class Trace:
    device: list          # (name, start_us, end_us), sorted by start
    host: list            # (name, start_us, end_us), sorted by start
    wall_s: float         # the traced window, host clock
    span: tuple = None    # the traced window on the profiler's clock (us)

    def by_name(self) -> dict:
        """Device seconds by operation name."""
        out = defaultdict(float)
        for name, s, e in self.device:
            out[name] += (e - s) / 1e6
        return dict(out)

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name contains ``pattern``."""
        return sum(e - s for n, s, e in self.device if pattern in n) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        return sum(e - s for s, e in self._merged()) / 1e6

    def _merged(self):
        out = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def idle_gaps(self) -> dict:
        """Idle device seconds by what the host was doing in each gap,
        over the traced window (from the first device operation to the
        last where the window is not known)."""
        merged = self._merged()
        if merged and self.span is not None:
            merged = [[self.span[0]] * 2] + merged + [[self.span[1]] * 2]
        starts = [s for _, s, _ in self.host]
        spans = [h for h in self.host if h[0].startswith("pb.")]
        span_starts = [s for _, s, _ in spans]
        out = defaultdict(float)
        for (_, a), (b, _) in zip(merged, merged[1:]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label = (f"{_innermost(spans, span_starts, mid)} / "
                     f"{_innermost(self.host, starts, mid)}")
            out[label] += (b - a) / 1e6
        return dict(out)


def _innermost(ranges, starts, t) -> str:
    """Name of the latest-starting range that covers ``t`` (ranges of one
    thread nest), or ``python`` where none does."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4096, -1), -1):
        name, s, e = ranges[j]
        if s <= t <= e:
            return name
    return "python"


def traced(fn):
    """(fn's result, Trace) of one call of ``fn`` under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        with torch.profiler.record_function("pb.sample"):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        wall = time.perf_counter() - t
    device, host = [], []
    for e in prof.events():
        rng = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type != DeviceType.CUDA:
            host.append(rng)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("pb.")):
            device.append(rng)     # not a host range mirrored on the device
    device.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    span = next(((s, e) for n, s, e in host if n == "pb.sample"), None)
    return out, Trace(device=device, host=host, wall_s=wall, span=span)


def device_busy(fn):
    """(fn's result, device-busy seconds, device operations) of one call of
    ``fn`` under the profiler with the device's activity alone: the union
    of the intervals of its kernels, copies and memsets, as
    ``Trace.busy_s``.  No host operation is recorded, so the host's issue
    is barely slowed, and the kernels' own times are as unprofiled."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    device = []
    try:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            s = e.start_ns() / 1e3
            device.append((e.name(), s, s + e.duration_ns() / 1e3))
    except AttributeError:      # a profiler without the raw events' accessors
        device = [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    device.sort(key=lambda r: r[1])
    return out, Trace(device=device, host=[], wall_s=0.0).busy_s(), len(device)


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time and the ten largest
    idle shares by host activity, in seconds."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(trace.by_name()), "idle_gaps": top(trace.idle_gaps())}
