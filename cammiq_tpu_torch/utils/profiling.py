"""``torch.profiler`` trace of a block: the counterpart of
``cammiq_tpu/utils/profiling.py:device_trace`` (a ``jax.profiler`` trace
in TensorBoard's format).  The trace is a Chrome trace,
``cammiq_query.rank<r>.pt.trace.json``, which TensorBoard's PyTorch
profiler plugin and ``chrome://tracing`` read; each rank of a grid writes
its own.  The tracer (``utils/timing.py``) is on for the block, so the
trace also holds the program's spans as host ranges, each with the read
set it serves as its ``read_set`` argument (the profiler records shapes
for that); what the tracer recorded in memory is dropped at the end."""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

from .timing import TRACER, take, tracing


def trace_path(logdir: str, rank: int = 0) -> str:
    return os.path.join(logdir, f"cammiq_query.rank{rank}.pt.trace.json")


@contextlib.contextmanager
def device_trace(logdir: Optional[str], device="cpu", rank: int = 0):
    """Trace the host and, on a CUDA ``device``, the card around a block
    into ``trace_path(logdir, rank)``, the tracer on; no-op when logdir is
    falsy."""
    if not logdir:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    was_on = TRACER.on
    try:
        with profile(activities=acts, record_shapes=True) as prof, tracing():
            yield
    finally:
        if not was_on:
            take()
    prof.export_chrome_trace(trace_path(logdir, rank))
