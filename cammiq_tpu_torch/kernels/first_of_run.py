"""First-of-run segmented scan: plain PyTorch version + CUDA kernel wrapper.

Replaces ``benchmarks/pallas_repro.py:first_of_run_scan_pallas`` and its XLA
twin ``cammiq_tpu/query/sortjoin.py:_first_of_run_scan``, following the
twin's semantics (the one the query path calls):

    out_k[i] = values_k[j] at the last j <= i with is_start[j],
               values_k[0] when no start precedes i.

Kernel: ``csrc/first_of_run.cu`` (three passes: tile scan, summary scan,
leading-run fix-up; see the source note).  On the match-assembly path it
ranks each distinct match within its read.
"""

from __future__ import annotations

import torch

from .build import I32, VP, CudaKernel, check_tensor, stream_ptr

MAX_VALUES = 4

KERNEL = CudaKernel("cammiq_first_of_run", [VP, I32, I32] + [VP] * 12)


def first_of_run_scan_plain(is_start: torch.Tensor, *values: torch.Tensor):
    """Reference version: prefix max of start indices, then a gather."""
    n = is_start.shape[0]
    idx = torch.arange(n, device=is_start.device)
    last = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return tuple(v[last] for v in values)


def first_of_run_scan(is_start: torch.Tensor, *values: torch.Tensor):
    """bool [n] run starts, 1-4 int32 [n] arrays -> tuple of int32 [n].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not 1 <= len(values) <= MAX_VALUES:
        raise ValueError(f"first_of_run_scan takes 1..{MAX_VALUES} value arrays")
    if is_start.device.type == "cpu":
        return first_of_run_scan_plain(is_start, *values)
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
    outs = [torch.empty_like(v) for v in values]
    if n == 0:
        return tuple(outs)
    ntiles = -(-n // tile())
    scratch = torch.empty((3, ntiles), dtype=torch.int32, device=dev)
    vp = [v.data_ptr() for v in values] + [None] * (MAX_VALUES - len(values))
    op = [o.data_ptr() for o in outs] + [None] * (MAX_VALUES - len(values))
    KERNEL(is_start.data_ptr(), n, len(values), *vp, *op,
           scratch[0].data_ptr(), scratch[1].data_ptr(),
           scratch[2].data_ptr(), stream_ptr(dev))
    return tuple(outs)


def tile() -> int:
    from .build import load

    return load().cammiq_first_of_run_tile()
