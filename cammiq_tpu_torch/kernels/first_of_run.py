"""First-of-run segmented scan: plain PyTorch version + CUDA kernel wrapper.

Replaces ``benchmarks/pallas_repro.py:first_of_run_scan_pallas`` and its XLA
twin ``cammiq_tpu/query/sortjoin.py:_first_of_run_scan``, following the
twin's semantics (the one the query path calls):

    out_k[i] = values_k[j] at the last j <= i with is_start[j],
               values_k[0] when no start precedes i.

Two more modes serve the device build's run bounds (``index/unique.py``):
with no value array the scan returns the index ``j`` itself (index mode),
and ``reverse=True`` takes the first ``j >= i`` with ``is_start[j]`` instead
(``n - 1``, or ``values_k[n - 1]``, when none follows) - the forward scan
of the flipped arrays, without the flips.

Kernel: ``csrc/first_of_run.cu`` (one pass, decoupled look-back; see the
source note).  On the match-assembly path it ranks each distinct match
within its read.
"""

from __future__ import annotations

import functools

import torch

from .build import I32, VP, CudaKernel, check_tensor, stream_ptr

MAX_VALUES = 4

KERNEL = CudaKernel("cammiq_first_of_run", [VP, I32, I32, I32] + [VP] * 11)


def first_of_run_scan_plain(is_start: torch.Tensor, *values: torch.Tensor,
                            reverse: bool = False):
    """Reference version: prefix max of start indices, then a gather."""
    n = is_start.shape[0]
    idx = torch.arange(n, device=is_start.device)
    if reverse:
        last = torch.cummax(torch.where(is_start.flip(0), idx, 0), 0).values
        last = n - 1 - last.flip(0)
    else:
        last = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    if not values:
        return (last.to(torch.int32),)
    return tuple(v[last] for v in values)


def first_of_run_scan(is_start: torch.Tensor, *values: torch.Tensor,
                      reverse: bool = False):
    """bool [n] run starts, 0-4 int32 [n] arrays -> tuple of int32 [n]
    (the index itself when no array is given).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if len(values) > MAX_VALUES:
        raise ValueError(f"first_of_run_scan takes 0..{MAX_VALUES} value arrays")
    if is_start.device.type == "cpu":
        return first_of_run_scan_plain(is_start, *values, reverse=reverse)
    dev = is_start.device
    if dev.type != "cuda":
        raise ValueError(f"first_of_run_scan: unsupported device {dev}")
    n = is_start.shape[0]
    check_tensor(is_start, "is_start", torch.bool, dev, 1)
    for k, v in enumerate(values):
        check_tensor(v, f"values[{k}]", torch.int32, dev, 1)
        if v.shape[0] != n:
            raise ValueError(f"values[{k}]: length {v.shape[0]}, expected {n}")
    if n >= 2**31:
        raise ValueError("first_of_run_scan: n must be < 2^31")
    outs = [torch.empty(n, dtype=torch.int32, device=dev)
            for _ in range(max(len(values), 1))]
    if n == 0:
        return tuple(outs)
    scratch = torch.empty(-(-n // tile()) + 1, dtype=torch.int64, device=dev)
    pad = [None] * (MAX_VALUES - len(values))
    vp = [v.data_ptr() for v in values] + pad
    op = [o.data_ptr() for o in outs[:len(values)]] + pad
    KERNEL(is_start.data_ptr(), n, len(values), int(reverse), *vp, *op,
           None if values else outs[0].data_ptr(), scratch.data_ptr(),
           stream_ptr(dev))
    return tuple(outs)


@functools.cache
def tile() -> int:
    from .build import load

    return load().cammiq_first_of_run_tile()
