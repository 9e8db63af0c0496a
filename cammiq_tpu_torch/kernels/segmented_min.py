"""Segmented inclusive min-scan: plain PyTorch version + CUDA kernel wrapper.

Replaces ``cammiq_tpu/ops/scans_jax.py:segmented_cummin_jax`` and
``segmented_cummin_rev_jax`` (XLA), which the device build's LCP0 and
LCP0-D stages call (``index/unique.py``).  For non-negative int32 ``v``:

    forward: out[i] = min v[s..i], s the last j <= i with flags[j]
             (0 when none);
    reverse: out[i] = min v[i..e], e the first j >= i with flags[j]
             (n - 1 when none).

The plain version runs one ``torch.cummin`` over the int64 key
``(nseg - 1 - seg) << 32 | v``: every earlier segment's keys are larger, so
the running minimum never crosses a segment start, and the low 32 bits
give the value.  Exact for values in [0, 2^32), which LCPs are.  Its
reverse scan is the forward one of the flipped arrays.

Kernel: ``csrc/segmented_min.cu`` (one pass, decoupled look-back, no
flips; see the source note).  Its values must lie in [0, 2^31); the
wrapper cannot check that without a host sync.
"""

from __future__ import annotations

import functools

import torch

from .build import I32, VP, CudaKernel, check_tensor, stream_ptr

KERNEL = CudaKernel("cammiq_segmented_min", [VP, VP, I32, I32, VP, VP, VP])


def _cummin_forward(v: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    if v.shape[0] == 0:
        return v.clone()
    seg = torch.cumsum(flags, 0, dtype=torch.int64)
    key = ((seg[-1] - seg) << 32) | v.to(torch.int64)
    del seg
    out = torch.cummin(key, 0).values
    del key
    return (out & 0xFFFFFFFF).to(v.dtype)


def segmented_min_plain(v: torch.Tensor, flags: torch.Tensor,
                        reverse: bool = False) -> torch.Tensor:
    """Reference version: the int64-key ``torch.cummin``."""
    if reverse:
        return _cummin_forward(v.flip(0), flags.flip(0)).flip(0)
    return _cummin_forward(v, flags)


def segmented_min(v: torch.Tensor, flags: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """int32 [n] non-negative values, bool [n] segment flags -> int32 [n].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    dev = v.device
    check_tensor(v, "v", torch.int32, dev, 1)
    check_tensor(flags, "flags", torch.bool, dev, 1)
    if flags.shape != v.shape:
        raise ValueError(f"flags: length {flags.shape[0]}, expected {v.shape[0]}")
    if dev.type == "cpu":
        return segmented_min_plain(v, flags, reverse=reverse)
    if dev.type != "cuda":
        raise ValueError(f"segmented_min: unsupported device {dev}")
    n = v.shape[0]
    if n >= 2**31:
        raise ValueError("segmented_min: n must be < 2^31")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    scratch = torch.empty(-(-n // tile()) + 1, dtype=torch.int64, device=dev)
    KERNEL(v.data_ptr(), flags.data_ptr(), n, int(reverse), out.data_ptr(),
           scratch.data_ptr(), stream_ptr(dev))
    return out


@functools.cache
def tile() -> int:
    from .build import load

    return load().cammiq_segmented_min_tile()
