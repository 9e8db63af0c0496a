"""Probe words + prefix hash + bloom test + compaction of the survivors:
plain PyTorch version + wrapper.

Replaces ``cammiq_tpu/query/probe.py:pack_rolling16``, the kw-word window
stack of ``query/sortjoin.py:collect_matches_sortjoin`` (867-898),
``_hash_prefix`` (411-432), ``_bloom_bits``/``_bloom_maybe`` (130-176) and
the compaction of the maybe rows (929-941).  Rows are the (read b, offset
o < O = max(Lp - h + 1, 1)) pairs, row i = b * O + o, N = B * O of them:

    key(i)   = primary 32-bit hash of the h-base prefix at (b, o)
    maybe(i) = all 3 bloom bits of key(i) are set in its bloom word

The test may run in two levels: ``l1`` (``2^l1_log`` words, l1_log <
bloom_log) is the bloom OR-folded (``query/merged.py:_fold_bloom``), which
holds every bit the bloom holds, so a row is tested against the bloom only
where it passes ``l1`` and the maybe rows are those of the bloom alone.  ``counts`` (int32
[2]), when given, gets the rows sent to level 2 (every row where there is
no ``l1``) and the maybe rows added in place.

The outputs are the maybe rows only, compacted in ascending order:
``rows[:n]`` (what ``torch.nonzero(maybe)`` gives), ``keys[:n]`` = their
keys, and ``n`` as an int32 tensor on the rows' device.  The capacity is N,
so nothing overflows; entries past n are unspecified.

Kernel: ``csrc/probe_bloom.cu`` (a tile of whole reads per block, one
pass, decoupled look-back for the order; see the source note).  It reads
``n`` on the device only: a CUDA call makes no host sync.
"""

from __future__ import annotations

import torch

from .. import u32
from .build import I32, VP, CudaKernel, check_tensor, load, stream_ptr

KERNEL = CudaKernel("cammiq_probe_bloom", [VP, I32, I32, I32, VP, I32, VP, I32,
                                           VP, VP, VP, VP, VP, VP])
# longest batch width the kernel takes: one read's codes and packed words
# (5 bytes a base) must fit a block's 227 KB of shared memory
MAX_LP = 40_000


def num_offsets(Lp: int, h: int) -> int:
    return max(Lp - h + 1, 1)


def window_words(codes: torch.Tensor, starts: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """16-base rolling words (int64, uint32 bits): for each (rows[j],
    starts[j, ...]) the word ORing codes[row, t + s] << 2s, with codes at
    or past Lp read as 0 (``pack_rolling16``).  A -1 code widens to
    0xFFFFFFFF, so its field is not disjoint from the higher ones: the
    words are ORed, not summed."""
    Lp = codes.shape[1]
    s = torch.arange(16, device=codes.device)
    t = starts.unsqueeze(-1) + s                        # [..., 16]
    inb = t < Lp
    r = rows.reshape(rows.shape + (1,) * (t.dim() - rows.dim()))
    c = codes[r, t.clamp(max=max(Lp - 1, 0))] if Lp else torch.zeros_like(t)
    c = torch.where(inb, u32.widen(c), 0) << (2 * s)
    w = c[..., 0]
    for k in range(1, 16):
        w = w | c[..., k]
    return w & u32.M32


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


def probe_keys_plain(codes: torch.Tensor, h: int) -> torch.Tensor:
    """int64 uint32 prefix hash of every row, [B * O]."""
    B, Lp = codes.shape
    O = num_offsets(Lp, h)
    o = torch.arange(O, device=codes.device).expand(B, O)
    b = torch.arange(B, device=codes.device)
    lo = window_words(codes, o, b) & u32.const_mask(min(h, 16))
    if h > 16:
        hi = window_words(codes, o + 16, b) & u32.const_mask(h - 16)
    else:
        hi = torch.zeros_like(lo)
    return hash_prefix_lo(lo, hi).reshape(-1)


def probe_bloom_plain(codes: torch.Tensor, bloom: torch.Tensor, h: int,
                      bloom_log: int, l1: torch.Tensor | None = None,
                      l1_log: int = 0, counts: torch.Tensor | None = None):
    """The same contract as ``probe_bloom`` (entries past n are 0), by the
    kernel's two tests; ``torch.nonzero`` makes a host sync."""
    key = probe_keys_plain(codes, h)
    need = bloom_bits(key)
    sent = torch.arange(key.shape[0], device=codes.device)
    if l1 is not None:
        word = u32.widen(l1)[key >> (32 - l1_log)]
        (sent,) = torch.nonzero((word & need) == need, as_tuple=True)
    word = u32.widen(bloom)[key[sent] >> (32 - bloom_log)]
    hit = sent[(word & need[sent]) == need[sent]]
    N, n = key.shape[0], hit.shape[0]
    if counts is not None:
        counts[:2] += torch.tensor([sent.shape[0], n], dtype=counts.dtype,
                                   device=counts.device)
    rows = torch.zeros(N, dtype=torch.int32, device=codes.device)
    keys = torch.zeros(N, dtype=torch.int32, device=codes.device)
    rows[:n] = hit.to(torch.int32)
    keys[:n] = u32.narrow(key[hit])
    return rows, keys, torch.tensor([n], dtype=torch.int32, device=codes.device)


def probe_bloom(codes: torch.Tensor, bloom: torch.Tensor, h: int,
                bloom_log: int, l1: torch.Tensor | None = None,
                l1_log: int = 0, counts: torch.Tensor | None = None):
    """int8 codes [B, Lp], int32 bloom [2^bloom_log], optional int32 l1
    [2^l1_log] -> (rows int32 [N], keys int32 [N] carrying uint32 bits, n
    int32 [1]), N = B * O; ``counts`` (int32 [2]) += the rows sent to
    level 2 and n."""
    if codes.device.type == "cpu":
        return probe_bloom_plain(codes, bloom, h, bloom_log, l1, l1_log, counts)
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"probe_bloom: unsupported device {dev}")
    check_tensor(codes, "codes", torch.int8, dev, 2)
    check_tensor(bloom, "bloom", torch.int32, dev, 1)
    if bloom.shape[0] != 1 << bloom_log or not 1 <= bloom_log <= 31:
        raise ValueError(f"bloom: {bloom.shape[0]} words, log {bloom_log}")
    if l1 is not None:
        check_tensor(l1, "l1", torch.int32, dev, 1)
        if l1.shape[0] != 1 << l1_log or not 1 <= l1_log < bloom_log:
            raise ValueError(f"l1: {l1.shape[0]} words, log {l1_log} "
                             f"(bloom log {bloom_log})")
    if counts is not None:
        check_tensor(counts, "counts", torch.int32, dev, 1)
        if counts.shape[0] < 2:
            raise ValueError(f"counts: {counts.shape[0]} slots, need 2")
    if not 1 <= h <= 32:
        raise ValueError(f"h={h} out of range")
    B, Lp = codes.shape
    N = B * num_offsets(Lp, h)
    if N >= 2**31 or Lp > MAX_LP:
        raise ValueError(f"probe_bloom: {B} x {Lp} codes exceed the kernel's "
                         f"int32 rows or its {MAX_LP}-base reads")
    rows = torch.empty(N, dtype=torch.int32, device=dev)
    keys = torch.empty(N, dtype=torch.int32, device=dev)
    n = torch.empty(1, dtype=torch.int32, device=dev)
    tiles = load().cammiq_probe_bloom_tiles(B, Lp, h)
    scratch = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
    KERNEL(codes.data_ptr(), B, Lp, h, bloom.data_ptr(), bloom_log,
           None if l1 is None else l1.data_ptr(), l1_log if l1 is not None else 0,
           rows.data_ptr(), keys.data_ptr(), n.data_ptr(),
           None if counts is None else counts.data_ptr(), scratch.data_ptr(),
           stream_ptr(dev))
    return rows, keys, n
