"""uint32 wraparound arithmetic for the plain PyTorch versions.

32-bit hash words travel as int32 tensors carrying the uint32 bits (torch's
uint32 lacks shifts, ``+`` and compares).  The plain versions widen them to
int64 in [0, 2^32), compute, and mask with ``M32``; products are split into
16-bit halves so no intermediate leaves int64's range.  The CUDA kernels
read the same buffers as ``uint32_t*``.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def bits32(a) -> np.ndarray:
    """Host array (uint32 or int32, memmap allowed; other integers cast)
    -> contiguous int32 carrying the same 32 bits."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype in (np.uint32, np.int32) else a.astype(np.int32)


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 (uint32 bits) or any integer tensor -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & M32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 carrying the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def mul(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) and a constant c < 2^32."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def base_mask(nb: torch.Tensor) -> torch.Tensor:
    """Mask of the low nb bases (2 bits each) for nb in [0, 16]."""
    return torch.where(nb >= 16, M32, (1 << (2 * nb.clamp(max=15))) - 1)


def const_mask(nb: int) -> int:
    return M32 if nb >= 16 else (1 << (2 * nb)) - 1
