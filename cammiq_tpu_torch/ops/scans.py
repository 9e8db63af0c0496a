"""Segmented cumulative minima: twins of ``cammiq_tpu/ops/scans_jax.py``.

The JAX versions double a Hillis-Steele stride with a boundary guard.
Here one ``torch.cummin`` runs over the int64 key
``(nseg - 1 - seg) << 32 | v``: every earlier segment's keys are larger,
so the running minimum never crosses a segment start, and the low 32 bits
give the value.  Exact for values in [0, 2^32), which LCPs are.
"""

from __future__ import annotations

import torch


def segmented_cummin(v: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Inclusive forward segmented cumulative min of non-negative int32
    ``v`` [n]; ``starts`` (bool [n]) marks each segment's first element."""
    if v.shape[0] == 0:
        return v.clone()
    seg = torch.cumsum(starts, 0, dtype=torch.int64)
    key = ((seg[-1] - seg) << 32) | v.to(torch.int64)
    del seg
    out = torch.cummin(key, 0).values
    del key
    return (out & 0xFFFFFFFF).to(v.dtype)


def segmented_cummin_rev(v: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The same scan run from the back; ``ends`` marks each segment's last
    element."""
    return segmented_cummin(v.flip(0), ends.flip(0)).flip(0)
