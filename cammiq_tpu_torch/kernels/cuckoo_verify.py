"""Cuckoo span lookup + bucket-scan verify into a compacted match list:
plain PyTorch version + wrapper.

Replaces ``cammiq_tpu/query/sortjoin.py:_cuckoo_pos``/``_cuckoo_lookup``
(214-223, 323-341), the bucket scan with ``_verify`` (1142-1239) and the
compaction of the found slots to the capacity KP (1268-1282).  Input:
``probe_bloom``'s output - ``rows`` and ``keys`` of capacity N = B * O,
the survivors in ``rows[:n]`` (= read * O + offset), ``n`` an int32 [1]
tensor.  For each survivor and chain color, the entry e of the survivor's
bucket span whose key matches the read at that offset (its length fits in
the rest of the read, every masked 2-bit word equal; the last such entry
of the span, as JAX's found slots keep it) is one match (row, e).
Outputs:

    mrow, me  int32 [kp]: the matches, in no particular order, in the
              first min(found, kp) slots (the rest unspecified)
    counts    int32 [2]: (matches found, matches beyond kp)

Kernel: ``csrc/cuckoo_verify.cu`` (persistent grid over the survivors,
warp-aggregated appends; see the source note).  It reads ``n`` on the
device only: a CUDA call makes no host sync.
"""

from __future__ import annotations

import torch

from .. import u32
from .build import I32, I64, VP, CudaKernel, check_tensor, stream_ptr
from .probe_bloom import window_words

CUCKOO_SLOTS = 4
MAX_COLORS = 64       # the kernel keeps one bit per color

KERNEL = CudaKernel("cammiq_cuckoo_verify",
                    [VP, VP, VP, I32, VP, I32, I32, VP, VP, I32, VP, I32, I64,
                     I32, VP, VP, I32, VP, VP])


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


def cuckoo_verify_plain(rows, keys, n, codes, lengths, cuckoo, tlog, erec,
                        n_colors, kp):
    """The same contract as ``cuckoo_verify``, the matches in (survivor,
    color) order and the slots past them 0; reading n makes a host
    sync.  found [K, n_colors] holds each survivor's entry per color,
    later span entries overwriting earlier, as JAX's where-chain does."""
    K = int(n[0])
    O = rows.shape[0] // codes.shape[0]
    rows, keys = rows[:K], keys[:K]
    kw = erec.shape[1] - 1
    E = erec.shape[0]
    dev = rows.device
    found = torch.full((K, n_colors), -1, dtype=torch.int32, device=dev)
    if K:
        ok, start, count = cuckoo_lookup_plain(cuckoo, tlog, u32.widen(keys))
        r = rows.long() // O
        o = rows.long() % O
        pw = window_words(codes, o[:, None] + 16 * torch.arange(kw, device=dev),
                          r)                                   # [K, kw]
        avail = lengths[r].to(torch.int64) - o
        count = torch.where(ok, count, 0).to(torch.int64)
        start = start.to(torch.int64)
        ar = torch.arange(K, device=dev)
        for c in range(int(count.max())):
            e = torch.clamp(start + c, max=E - 1)
            er = u32.widen(erec[e])                            # [K, kw+1]
            elen = er[:, kw] & 0xFFFF
            ecol = er[:, kw] >> 16
            match = (c < count) & (elen <= avail) & (ecol < n_colors)
            for w in range(kw):
                nb = torch.clamp(elen - 16 * w, 0, 16)
                match &= (pw[:, w] & u32.base_mask(nb)) == er[:, w]
            found[ar[match], ecol[match]] = e[match].to(torch.int32)
    fi, col = torch.nonzero(found >= 0, as_tuple=True)
    total = fi.shape[0]
    m = min(total, kp)
    mrow = torch.zeros(kp, dtype=torch.int32, device=dev)
    me = torch.zeros(kp, dtype=torch.int32, device=dev)
    mrow[:m] = rows[fi[:m]]
    me[:m] = found[fi[:m], col[:m]]
    counts = torch.tensor([total, total - m], dtype=torch.int32, device=dev)
    return mrow, me, counts


def cuckoo_verify(rows: torch.Tensor, keys: torch.Tensor, n: torch.Tensor,
                  codes: torch.Tensor, lengths: torch.Tensor,
                  cuckoo: torch.Tensor, tlog: int, erec: torch.Tensor,
                  n_colors: int, kp: int):
    """int32 rows/keys [B*O] with int32 n [1] (``probe_bloom``'s output),
    int8 codes [B, Lp], int32 lengths [B], int32 cuckoo [2^tlog, 12],
    int32 erec [E, kw+1] -> (mrow int32 [kp], me int32 [kp], counts int32
    [2])."""
    if rows.device.type == "cpu":
        return cuckoo_verify_plain(rows, keys, n, codes, lengths, cuckoo,
                                   tlog, erec, n_colors, kp)
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"cuckoo_verify: unsupported device {dev}")
    check_tensor(rows, "rows", torch.int32, dev, 1)
    check_tensor(keys, "keys", torch.int32, dev, 1)
    check_tensor(n, "n", torch.int32, dev, 1)
    check_tensor(codes, "codes", torch.int8, dev, 2)
    check_tensor(lengths, "lengths", torch.int32, dev, 1)
    check_tensor(cuckoo, "cuckoo", torch.int32, dev, 2)
    check_tensor(erec, "erec", torch.int32, dev, 2)
    B, Lp = codes.shape
    cap = rows.shape[0]
    if (B == 0 or cap % B or keys.shape[0] != cap or n.shape[0] != 1
            or lengths.shape[0] != B):
        raise ValueError("rows/keys must be [B*O], n [1] and lengths [B] for "
                         "codes [B, Lp]")
    if cuckoo.shape != (1 << tlog, 3 * CUCKOO_SLOTS) or not 1 <= tlog <= 31:
        raise ValueError(f"cuckoo: shape {tuple(cuckoo.shape)}, log {tlog}")
    if erec.shape[1] < 2:
        raise ValueError("erec must be [E, kw+1] with kw >= 1")
    if not 1 <= n_colors <= MAX_COLORS or not 0 <= kp < 2**31:
        raise ValueError(f"n_colors={n_colors} (1..{MAX_COLORS}), kp={kp}")
    mrow = torch.empty(kp, dtype=torch.int32, device=dev)
    me = torch.empty(kp, dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    KERNEL(rows.data_ptr(), keys.data_ptr(), n.data_ptr(), cap,
           codes.data_ptr(), Lp, cap // B, lengths.data_ptr(),
           cuckoo.data_ptr(), tlog, erec.data_ptr(), erec.shape[1] - 1,
           erec.shape[0], n_colors, mrow.data_ptr(), me.data_ptr(), kp,
           counts.data_ptr(), stream_ptr(dev))
    return mrow, me, counts
