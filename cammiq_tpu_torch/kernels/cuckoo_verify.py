"""Cuckoo span lookup + bucket-scan verify: plain PyTorch version + wrapper.

Replaces ``cammiq_tpu/query/sortjoin.py:_cuckoo_pos``/``_cuckoo_lookup``
(214-223, 323-341) and the bucket scan with ``_verify`` (1142-1239).  For
each surviving probe row ``rows[i]`` (= read * O + offset):

    found[i, color] = entry e of the row's bucket span whose key matches
                      the read at that offset (its length fits in the
                      rest of the read, every masked 2-bit word equal),
                      -1 where no entry of that chain color matches.

Kernel: ``csrc/cuckoo_verify.cu`` (one thread per row; see the source note).
"""

from __future__ import annotations

import torch

from .. import u32
from .build import I32, I64, VP, CudaKernel, check_tensor, stream_ptr
from .probe_bloom import window_words

CUCKOO_SLOTS = 4

KERNEL = CudaKernel("cammiq_cuckoo_verify",
                    [VP, I64, VP, VP, I32, I32, VP, VP, I32, VP, I32, I64,
                     I32, VP, VP])


def cuckoo_pos(key: torch.Tensor, which: int, tlog: int) -> torch.Tensor:
    """``_cuckoo_pos`` on int64 uint32 keys."""
    if which == 0:
        z = u32.mul(key, 0x9E3779B1)
    else:
        z = u32.mul(key ^ 0x85EBCA6B, 0xC2B2AE35)
        z = z ^ (z >> 15)
    return z >> (32 - tlog)


def cuckoo_lookup_plain(cuckoo: torch.Tensor, tlog: int, ck: torch.Tensor):
    """(found bool, span start int32, span count int32) for int64 uint32
    keys ck - the ``_cuckoo_lookup`` twin (side 0 wins)."""
    S = CUCKOO_SLOTS

    def side(which):
        r = u32.widen(cuckoo[cuckoo_pos(ck, which, tlog)])    # [K, 3S]
        hit = (r[:, :S] == ck[:, None]) & (r[:, 2 * S:] > 0)
        st = torch.where(hit, r[:, S:2 * S], 0).sum(1)
        ct = torch.where(hit, r[:, 2 * S:], 0).sum(1)
        return hit.any(1), st, ct

    f1, s1, c1 = side(0)
    f2, s2, c2 = side(1)
    st = u32.narrow(torch.where(f1, s1, s2) & u32.M32)
    ct = u32.narrow(torch.where(f1, c1, c2) & u32.M32)
    return f1 | f2, st, ct


def cuckoo_verify_plain(rows, khlo, codes, lengths, cuckoo, tlog, erec,
                        n_colors):
    K = rows.shape[0]
    B, Lp = codes.shape
    kw = erec.shape[1] - 1
    E = erec.shape[0]
    O = khlo.shape[0] // max(B, 1)
    dev = rows.device
    found = torch.full((K, n_colors), -1, dtype=torch.int32, device=dev)
    if K == 0:
        return found
    ok, start, count = cuckoo_lookup_plain(cuckoo, tlog, u32.widen(khlo[rows]))
    r = rows // O
    o = rows % O
    pw = window_words(codes, o[:, None] + 16 * torch.arange(kw, device=dev),
                      r)                                       # [K, kw]
    avail = lengths[r].to(torch.int64) - o
    count = torch.where(ok, count, 0).to(torch.int64)
    start = start.to(torch.int64)
    ar = torch.arange(K, device=dev)
    for c in range(int(count.max())):
        e = torch.clamp(start + c, max=E - 1)
        er = u32.widen(erec[e])                                # [K, kw+1]
        elen = er[:, kw] & 0xFFFF
        ecol = er[:, kw] >> 16
        match = (c < count) & (elen <= avail) & (ecol < n_colors)
        for w in range(kw):
            nb = torch.clamp(elen - 16 * w, 0, 16)
            match &= (pw[:, w] & u32.base_mask(nb)) == er[:, w]
        found[ar[match], ecol[match]] = e[match].to(torch.int32)
    return found


def cuckoo_verify(rows: torch.Tensor, khlo: torch.Tensor, codes: torch.Tensor,
                  lengths: torch.Tensor, cuckoo: torch.Tensor, tlog: int,
                  erec: torch.Tensor, n_colors: int) -> torch.Tensor:
    """int64 rows [K] into the [B*O] probe grid, int32 khlo [B*O], int8
    codes [B, Lp], int32 lengths [B], int32 cuckoo [2^tlog, 12], int32
    erec [E, kw+1] -> found int32 [K, n_colors]."""
    if rows.device.type == "cpu":
        return cuckoo_verify_plain(rows, khlo, codes, lengths, cuckoo, tlog,
                                   erec, n_colors)
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"cuckoo_verify: unsupported device {dev}")
    check_tensor(rows, "rows", torch.int64, dev, 1)
    check_tensor(khlo, "khlo", torch.int32, dev, 1)
    check_tensor(codes, "codes", torch.int8, dev, 2)
    check_tensor(lengths, "lengths", torch.int32, dev, 1)
    check_tensor(cuckoo, "cuckoo", torch.int32, dev, 2)
    check_tensor(erec, "erec", torch.int32, dev, 2)
    B, Lp = codes.shape
    if B == 0 or khlo.shape[0] % B or lengths.shape[0] != B:
        raise ValueError("khlo must be [B*O] and lengths [B] for codes [B, Lp]")
    if cuckoo.shape != (1 << tlog, 3 * CUCKOO_SLOTS) or not 1 <= tlog <= 31:
        raise ValueError(f"cuckoo: shape {tuple(cuckoo.shape)}, log {tlog}")
    if erec.shape[1] < 2 or n_colors < 1:
        raise ValueError("erec must be [E, kw+1] and n_colors >= 1")
    O = khlo.shape[0] // B
    K = rows.shape[0]
    found = torch.empty((K, n_colors), dtype=torch.int32, device=dev)
    if K:
        KERNEL(rows.data_ptr(), K, khlo.data_ptr(), codes.data_ptr(), Lp, O,
               lengths.data_ptr(), cuckoo.data_ptr(), tlog, erec.data_ptr(),
               erec.shape[1] - 1, erec.shape[0], n_colors, found.data_ptr(),
               stream_ptr(dev))
    return found
