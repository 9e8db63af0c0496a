"""Segmented cumulative minima: twins of ``cammiq_tpu/ops/scans_jax.py``.

The JAX versions double a Hillis-Steele stride with a boundary guard.
Here both directions are ``kernels/segmented_min.py``'s scan: on a CUDA
tensor one launch of ``csrc/segmented_min.cu`` (the reverse scan reads its
tiles from the back, with no flipped copies), on a CPU tensor its plain
version, an int64-key ``torch.cummin``.  Values are non-negative int32,
as LCPs are.
"""

from __future__ import annotations

import torch

from ..kernels.segmented_min import segmented_min


def segmented_cummin(v: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Inclusive forward segmented cumulative min of non-negative int32
    ``v`` [n]; ``starts`` (bool [n]) marks each segment's first element."""
    return segmented_min(v, starts)


def segmented_cummin_rev(v: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The same scan run from the back; ``ends`` marks each segment's last
    element."""
    return segmented_min(v, ends, reverse=True)
