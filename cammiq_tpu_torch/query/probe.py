"""The gather engine's index probe on torch tensors: port of
``cammiq_tpu/query/probe.py``.

Per read offset, both strands, both FlatIndex tables:

  reads [B, Lp] 2-bit codes
    -> rolling 16-base packed words P16 [B, Lp]
    -> per-offset window words W_w[b, o] = P16[b, o + 16 w]
    -> prefix (lo, hi) -> hash -> bounded open-addressing probe
    -> bounded bucket scan with masked full-key compare
    -> matched entry id per (b, o) or -1.

Index keys are prefix-free, so at most one entry matches at an offset; a
match needs the entry to lie inside the read (length <= rl - o).

``DeviceIndex`` holds a FlatIndex on an explicit device as int32 tensors
(the uint32 columns carry their bits, ``u32.py``).  Its fields are the JAX
package's; they are views of two packed tensors the kernel reads
(``kernels/gather_probe.py``): ``trec`` [T, 4] = (lo, hi, start, count),
one 16-byte row a table slot, and ``erec`` [E, rw] = (key words, length,
rid1, rid2), rw = kw + 3 rounded up to a multiple of 4.

``pack_rolling16``, ``hash_prefix`` and ``probe_strand`` are the plain
versions, op for op the JAX functions on int64 tensors holding uint32
values.  The hash is ``index/table.py:hash_prefix``, not the sort join's
``_hash_prefix``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import u32
from ..index.table import FlatIndex, hash_prefix as hash_prefix_np

_HASH_C1 = 0x85EBCA6B
_HASH_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


@dataclasses.dataclass
class DeviceIndex:
    """FlatIndex staged as int32 tensors on one device."""

    h: int
    kw: int
    max_probes: int
    max_bucket: int
    num_entries: int          # real entry count (before padding)
    table_bits: int
    erec: torch.Tensor        # int32 [E, rw] key words | length | rid1 | rid2
    trec: torch.Tensor        # int32 [T, 4] lo | hi | start | count
    key_words: torch.Tensor   # uint32 bits [E, kw] (view of erec)
    length: torch.Tensor      # int32 [E] (view)
    rid1: torch.Tensor        # int32 [E] (view)
    rid2: torch.Tensor        # int32 [E] (view)
    ucount1: torch.Tensor     # int32 [E]
    ucount2: torch.Tensor     # int32 [E]
    table_lo: torch.Tensor    # uint32 bits [T] (view of trec)
    table_hi: torch.Tensor    # uint32 bits [T] (view)
    table_start: torch.Tensor  # int32 [T] (view)
    table_count: torch.Tensor  # int32 [T] (view)

    @property
    def device(self) -> torch.device:
        return self.erec.device


def record_width(kw: int) -> int:
    """Words of an ``erec`` row: kw key words, length, rid1, rid2, padded
    to a multiple of 4 (16-byte rows)."""
    return (kw + 3 + 3) // 4 * 4


def check_probe_runs(table_lo, table_hi, table_start) -> None:
    """Raise ValueError unless every occupied row s of the hash table, of
    hash h = hash_prefix(lo, hi) & (T - 1), has h <= s and no empty row
    (start < 0) in [h, s].  ``index/table.py:_assign_slots`` builds every
    table so; the kernel's walk (``csrc/gather_probe.cu``) stops at the
    first empty row and is exact only on such a table."""
    start = u32.bits32(table_start)
    T = start.shape[0]
    rows = np.flatnonzero(start >= 0)
    if rows.size == 0:
        return
    rows = rows.astype(np.int32)
    hv = hash_prefix_np(u32.bits32(table_lo)[rows].view(np.uint32),
                        u32.bits32(table_hi)[rows].view(np.uint32))
    hv = (hv & np.uint32(T - 1)).view(np.int32)
    # empty[x] = empty rows before row x
    empty = np.zeros(T + 1, np.int32)
    np.cumsum(start < 0, dtype=np.int32, out=empty[1:])
    bad = (hv > rows) | (empty[rows + 1] != empty[np.minimum(hv, rows)])
    if bad.any():
        s = int(rows[np.argmax(bad)])
        h = int(hv[np.argmax(bad)])
        raise ValueError(
            f"hash table row {s} (of {T}) holds a prefix of hash row {h}, "
            + ("behind its hash" if h > s else "past an empty row in between")
            + ": not a table of linear-probe runs, which the probe needs")


def stage_index(h: int, kw: int, max_probes: int, max_bucket: int,
                num_entries: int, key_words, length, rid1, rid2, ucount1,
                ucount2, table_lo, table_hi, table_start, table_count,
                device) -> DeviceIndex:
    """Pack host arrays into a DeviceIndex on ``device``; ``max_probes``
    and ``max_bucket`` are taken as given.  The hash table must be runs of
    linear probing (``check_probe_runs``)."""
    check_probe_runs(table_lo, table_hi, table_start)
    E, T = int(length.shape[0]), int(table_start.shape[0])
    erec = np.zeros((E, record_width(kw)), np.int32)
    erec[:, :kw] = u32.bits32(key_words).reshape(E, kw)
    erec[:, kw] = u32.bits32(length)
    erec[:, kw + 1] = u32.bits32(rid1)
    erec[:, kw + 2] = u32.bits32(rid2)
    trec = np.stack([u32.bits32(x) for x in (table_lo, table_hi, table_start,
                                             table_count)], axis=1)
    erec = torch.from_numpy(erec).to(device)
    trec = torch.from_numpy(trec).to(device)
    return DeviceIndex(
        h=h, kw=kw, max_probes=max_probes, max_bucket=max_bucket,
        num_entries=num_entries, table_bits=T.bit_length() - 1,
        erec=erec, trec=trec,
        key_words=erec[:, :kw], length=erec[:, kw], rid1=erec[:, kw + 1],
        rid2=erec[:, kw + 2],
        ucount1=torch.from_numpy(u32.bits32(ucount1).copy()).to(device),
        ucount2=torch.from_numpy(u32.bits32(ucount2).copy()).to(device),
        table_lo=trec[:, 0], table_hi=trec[:, 1], table_start=trec[:, 2],
        table_count=trec[:, 3])


def to_device_index(idx: FlatIndex, device) -> DeviceIndex:
    """``cammiq_tpu/query/probe.py:to_device_index`` on ``device``.  An
    empty table gets one never-matching dummy entry (length 2^30), so its
    gathers keep valid shapes."""
    E = idx.num_entries
    if E == 0:
        key_words = np.zeros((1, idx.kw), np.uint32)
        length = np.full(1, 1 << 30, np.int32)
        rid1 = rid2 = uc1 = uc2 = np.zeros(1, np.int32)
    else:
        key_words, length = idx.key_words, idx.length
        rid1, rid2, uc1, uc2 = idx.rid1, idx.rid2, idx.ucount1, idx.ucount2
    return stage_index(idx.h, idx.kw, max(1, idx.max_probes),
                       max(1, idx.max_bucket), E, key_words, length, rid1,
                       rid2, uc1, uc2, idx.table_lo, idx.table_hi,
                       idx.table_start, idx.table_count, device)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = u32.mul(x, _HASH_C1)
    x = x ^ (x >> 13)
    x = u32.mul(x, _HASH_C2)
    return x ^ (x >> 16)


def hash_prefix(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``hash_prefix_j`` on int64 uint32 values."""
    return _mix32(lo ^ _mix32((hi + _GOLDEN) & u32.M32))


def pack_rolling16(codes: torch.Tensor) -> torch.Tensor:
    """codes int8/int32 [B, Lp] -> P16 int64 (uint32 values) [B, Lp]:
    P16[b, t] ORs codes[b, t+s] << 2s over s < 16 (codes past Lp read as
    0).  A code widens to uint32 first, so a -1 sets every bit from 2s up
    and a 4 (a -1 reverse-complemented) spills into the next field."""
    B, Lp = codes.shape
    c = torch.cat([u32.widen(codes),
                   torch.zeros(B, 16, dtype=torch.int64, device=codes.device)], 1)
    out = torch.zeros(B, Lp, dtype=torch.int64, device=codes.device)
    for s in range(16):
        out |= (c[:, s:s + Lp] << (2 * s)) & u32.M32
    return out


def _prefix_masks(h: int):
    return u32.const_mask(min(h, 16)), u32.const_mask(min(max(h - 16, 0), 16))


def probe_strand(didx: DeviceIndex, p16: torch.Tensor, lengths: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """Match entries at every offset of one strand.

    p16: int64 [B, Lp] rolling words; lengths: int32 [B]; offsets: [O]
    (an arange).  Returns int64 [B, O]: matched entry id or -1."""
    B, Lp = p16.shape
    O = offsets.shape[0]
    kw = didx.kw
    tmask = (1 << didx.table_bits) - 1
    dev = p16.device

    def window_word(w):
        # W_w[b, o] = p16[b, o + 16 w] (0 beyond Lp)
        start = 16 * w
        if start >= Lp:
            return torch.zeros(B, O, dtype=torch.int64, device=dev)
        sl = p16[:, start:]
        if sl.shape[1] < O:
            sl = torch.cat([sl, torch.zeros(B, O - sl.shape[1], dtype=torch.int64,
                                            device=dev)], 1)
        return sl[:, :O]

    W = [window_word(w) for w in range(kw)]
    m0, m1 = _prefix_masks(didx.h)
    plo = W[0] & m0
    phi = (W[1] & m1) if didx.h > 16 else torch.zeros_like(plo)

    slot0 = hash_prefix(plo, phi) & tmask
    bstart = torch.full((B, O), -1, dtype=torch.int64, device=dev)
    bcount = torch.zeros(B, O, dtype=torch.int64, device=dev)
    for p in range(didx.max_probes):
        slot = (slot0 + p) & tmask
        tlo = u32.widen(didx.table_lo[slot])
        thi = u32.widen(didx.table_hi[slot])
        ts = didx.table_start[slot].to(torch.int64)
        tc = didx.table_count[slot].to(torch.int64)
        hit = (tlo == plo) & (thi == phi) & (ts >= 0) & (bstart < 0)
        bstart = torch.where(hit, ts, bstart)
        bcount = torch.where(hit, tc, bcount)

    # bucket scan with masked full-key compare
    avail = lengths[:, None].to(torch.int64) - offsets[None, :]
    found = torch.full((B, O), -1, dtype=torch.int64, device=dev)
    e_base = bstart.clamp(min=0)
    E = didx.length.shape[0]
    for c in range(didx.max_bucket):
        valid = (bstart >= 0) & (c < bcount)
        e = (e_base + c).clamp(max=E - 1)
        elen = didx.length[e].to(torch.int64)
        match = valid & (elen <= avail) & (found < 0)
        for w in range(kw):
            mask = u32.base_mask((elen - 16 * w).clamp(0, 16))
            match = match & ((W[w] & mask) == u32.widen(didx.key_words[e, w]))
        found = torch.where(match, e, found)
    return found


def revcomp_batch(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-read reverse complement in the codes' dtype: rc[b, t] =
    3 - codes[b, rl-1-t] for t < rl, else 0 (a -1 code becomes 4)."""
    B, Lp = codes.shape
    t = torch.arange(Lp, device=codes.device)
    src = lengths[:, None].to(torch.int64) - 1 - t[None, :]
    valid = src >= 0
    g = torch.gather(codes, 1, src.clamp(0, max(Lp - 1, 0)))
    return torch.where(valid, 3 - g, 0).to(codes.dtype)
