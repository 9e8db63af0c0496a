"""LCP of suffix-array neighbours: plain PyTorch version + CUDA kernel wrapper.

Replaces the blockwise compare of ``cammiq_tpu/ops/lcp.py:lcp_jax`` with
``max_lcp=LCP_CLAMP``, as the JAX device build calls it
(``index/builder.py:69-71``).  For uint8 ``text`` [n] and int32 ``sa`` [m]
(a suffix array, or any contiguous run of one):

    out[i] = min(lcp(text[sa[i-1]:], text[sa[i]:]), clamp)   0 < i < m
    out[0] = out[m] = 0;  positions at or past n never match.

Kernel: ``csrc/lcp_pairs.cu`` (short pairs one thread each, long pairs one
warp each, in one call; see the source note).
"""

from __future__ import annotations

import torch

from .build import I32, I64, VP, CudaKernel, check_tensor, stream_ptr

LCP_CLAMP = 0xFFFF  # cammiq_tpu/ops/lcp.py:LCP_CLAMP (the reference's uint16)

KERNEL = CudaKernel("cammiq_lcp_pairs", [VP, I64, VP, I64, I32, VP, VP, VP])

_PAD_WORDS = 66  # the warp phase reads up to 65 words past a position < n

_CHUNK_BYTES = 1 << 24  # bytes gathered per chunk of the plain version


def lcp_pairs_plain(text: torch.Tensor, sa: torch.Tensor,
                    clamp: int = LCP_CLAMP) -> torch.Tensor:
    """Live-set blockwise extension (``ops/lcp.py:lcp_from_sa_numpy``):
    every round compares the next ``block`` bytes of each unresolved pair,
    then keeps only the pairs whose block matched in full.  The block grows
    4x a round from 32 to 2^14; the live set is processed in chunks of
    ``_CHUNK_BYTES`` bytes, so memory stays at that, not n x block."""
    n, m = text.shape[0], sa.shape[0]
    dev = text.device
    out = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    if m <= 1:
        return out
    a = sa[1:].to(torch.int64)
    b = sa[:-1].to(torch.int64)
    lim = (n - torch.maximum(a, b)).clamp_(max=clamp)
    cur = torch.zeros(m - 1, dtype=torch.int64, device=dev)
    live = torch.arange(m - 1, device=dev)
    block = 32
    while live.numel():
        offs = torch.arange(block, device=dev)
        step = max(_CHUNK_BYTES // block, 1)
        keep = []
        for c in range(0, live.numel(), step):
            p = live[c:c + step]
            base = cur[p].unsqueeze(1) + offs
            ta = text[(a[p].unsqueeze(1) + base).clamp_(max=n - 1)]
            tb = text[(b[p].unsqueeze(1) + base).clamp_(max=n - 1)]
            diff = ta != tb
            del ta, tb, base
            run = torch.where(diff.any(1), diff.to(torch.uint8).argmax(1), block)
            cur[p] += run
            keep.append(p[(run == block) & (cur[p] < lim[p])])
        live = torch.cat(keep)
        block = min(block * 4, 1 << 14)
    out[1:m] = torch.minimum(cur, lim).to(torch.int32)
    return out


def lcp_pairs(text: torch.Tensor, sa: torch.Tensor,
              clamp: int = LCP_CLAMP) -> torch.Tensor:
    """uint8 text [n], int32 sa [m] -> int32 [m + 1].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if text.device.type == "cpu":
        return lcp_pairs_plain(text, sa, clamp)
    dev = text.device
    if dev.type != "cuda":
        raise ValueError(f"lcp_pairs: unsupported device {dev}")
    check_tensor(text, "text", torch.uint8, dev, 1)
    check_tensor(sa, "sa", torch.int32, dev, 1)
    n, m = text.shape[0], sa.shape[0]
    if n >= 2**31 or m > n:
        raise ValueError(f"lcp_pairs: n={n}, m={m}; need m <= n < 2^31")
    if not 0 <= clamp < 2**31:
        raise ValueError(f"lcp_pairs: clamp {clamp} out of range")
    nw = (n + 7) // 8 + _PAD_WORDS
    words = torch.zeros(nw * 8, dtype=torch.uint8, device=dev)
    words[:n] = text
    out = torch.empty(m + 1, dtype=torch.int32, device=dev)
    # the long pairs' worklist (capacity m), then its length and cursor
    work = torch.empty(m + 2, dtype=torch.int32, device=dev)
    KERNEL(words.data_ptr(), n, sa.data_ptr(), m, clamp, out.data_ptr(),
           work.data_ptr(), stream_ptr(dev))
    return out
