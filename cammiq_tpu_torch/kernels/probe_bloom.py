"""Probe words + prefix hash + bloom test: plain PyTorch version + wrapper.

Replaces ``cammiq_tpu/query/probe.py:pack_rolling16``, the kw-word window
stack of ``query/sortjoin.py:collect_matches_sortjoin`` (867-898),
``_hash_prefix`` (411-432) and ``_bloom_bits``/``_bloom_maybe`` (130-176).
For every (read b, offset o < O = max(Lp - h + 1, 1)), row i = b * O + o:

    khlo[i]  = primary 32-bit hash of the h-base prefix at (b, o)
    maybe[i] = all 3 bloom bits of khlo[i] are set in its bloom word

Kernel: ``csrc/probe_bloom.cu`` (one thread per row; see the source note).
"""

from __future__ import annotations

import torch

from .. import u32
from .build import I32, I64, VP, CudaKernel, check_tensor, stream_ptr

KERNEL = CudaKernel("cammiq_probe_bloom", [VP, I64, I32, I32, VP, I32, VP, VP, VP])


def num_offsets(Lp: int, h: int) -> int:
    return max(Lp - h + 1, 1)


def window_words(codes: torch.Tensor, starts: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """16-base rolling words (int64, uint32 bits): for each (rows[j],
    starts[j, ...]) the word packing codes[row, t + s] into bits 2s, with
    codes at or past Lp read as 0 (``pack_rolling16``)."""
    Lp = codes.shape[1]
    s = torch.arange(16, device=codes.device)
    t = starts.unsqueeze(-1) + s                        # [..., 16]
    inb = t < Lp
    r = rows.reshape(rows.shape + (1,) * (t.dim() - rows.dim()))
    c = codes[r, t.clamp(max=max(Lp - 1, 0))]
    c = torch.where(inb, u32.widen(c), 0)
    return (c << (2 * s)).sum(-1) & u32.M32             # disjoint bit fields


def hash_prefix_lo(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``_hash_prefix`` primary half on int64 uint32 values."""
    x = lo ^ u32.mul(hi, 0x9E3779B1)
    x = u32.mul(x ^ (x >> 16), 0x85EBCA6B)
    x = u32.mul(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def bloom_bits(key: torch.Tensor) -> torch.Tensor:
    z = u32.mul(key, 0x9E3779B1)
    return ((1 << ((z >> 16) & 31)) | (1 << ((z >> 21) & 31))
            | (1 << ((z >> 26) & 31)))


def probe_bloom_plain(codes: torch.Tensor, bloom: torch.Tensor, h: int,
                      bloom_log: int):
    B, Lp = codes.shape
    O = num_offsets(Lp, h)
    dev = codes.device
    o = torch.arange(O, device=dev).expand(B, O)
    b = torch.arange(B, device=dev)
    lo = window_words(codes, o, b) & u32.const_mask(min(h, 16))
    if h > 16:
        hi = window_words(codes, o + 16, b) & u32.const_mask(h - 16)
    else:
        hi = torch.zeros_like(lo)
    key = hash_prefix_lo(lo, hi).reshape(-1)
    word = u32.widen(bloom)[key >> (32 - bloom_log)]
    need = bloom_bits(key)
    maybe = (word & need) == need
    return maybe.to(torch.uint8), u32.narrow(key)


def probe_bloom(codes: torch.Tensor, bloom: torch.Tensor, h: int,
                bloom_log: int):
    """int8 codes [B, Lp], int32 bloom [2^bloom_log] ->
    (maybe uint8 [B*O], khlo int32 [B*O] carrying uint32 bits)."""
    if codes.device.type == "cpu":
        return probe_bloom_plain(codes, bloom, h, bloom_log)
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"probe_bloom: unsupported device {dev}")
    check_tensor(codes, "codes", torch.int8, dev, 2)
    check_tensor(bloom, "bloom", torch.int32, dev, 1)
    if bloom.shape[0] != 1 << bloom_log or not 1 <= bloom_log <= 31:
        raise ValueError(f"bloom: {bloom.shape[0]} words, log {bloom_log}")
    if not 1 <= h <= 32:
        raise ValueError(f"h={h} out of range")
    B, Lp = codes.shape
    N = B * num_offsets(Lp, h)
    maybe = torch.empty(N, dtype=torch.uint8, device=dev)
    khlo = torch.empty(N, dtype=torch.int32, device=dev)
    if N:
        KERNEL(codes.data_ptr(), B, Lp, h, bloom.data_ptr(), bloom_log,
               maybe.data_ptr(), khlo.data_ptr(), stream_ptr(dev))
    return maybe, khlo
