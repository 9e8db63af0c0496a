"""Bloom -> cuckoo probe join on torch tensors (the query hot loop).

Port of the production path of ``cammiq_tpu/query/sortjoin.py``
(``collect_matches_sortjoin`` with ``join='bloom'``, 822-1310, and
``make_sortjoin_classifier``, 1313-1385).  The merged, RC-augmented,
chain-colored index is built on the host (``query/merged.py``); this
module carries it to the device and probes the forward strand only (see
``cammiq_tpu/query/sortjoin.py``'s docstring for why that is exact).

Per batch:
  1. kernel 2 (``probe_bloom``): prefix hash + bloom test for every
     (read, offset) row;
  2. ``torch.nonzero`` compaction of the maybe rows - sized at N, so the
     JAX path's hit capacities (K, K1, KP), which exist only because XLA
     needs static shapes, and their overflow cannot arise;
  3. kernel 3 (``cuckoo_verify``): exact span lookup + bucket scan;
  4. compaction of the found slots, the ``prec`` payload gather, one sort
     on the int64 key read * 2^31 + gid, dedup, rank within each read via
     kernel 1 (``first_of_run_scan``), scatter into [B, maxm] slots.
Slot overflow (more than maxm distinct matches in a read) is counted; the
session widens maxm and re-runs the pass.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.cuckoo_verify import cuckoo_verify
from ..kernels.first_of_run import first_of_run_scan
from ..kernels.probe_bloom import num_offsets, probe_bloom
from .classify import BIG, MatchSlots, case_analysis
from .merged import (
    BLOOM_DEVICE_LOG,
    MergedIndex,
    _build_bloom,
    _build_cuckoo,
    _fold_bloom,
    _fused_records,
)


def _as_i32(a: np.ndarray, device) -> torch.Tensor:
    """Host array (uint32 or int32, memmap allowed) -> int32 tensor on
    `device` carrying the same 32 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype not in (np.uint32, np.int32):
        a = a.astype(np.int32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


@dataclasses.dataclass
class TorchMergedIndex:
    """The four device arrays the probe path reads, plus its statics.

    ``pref_lo``/``pref_hi``/``brec``/``dir_start`` stay on the host: only
    the JAX package's dir and sort joins read them.

    ``from_merged`` and ``from_artifact`` read their source by its numpy
    attributes only, so they take this package's ``MergedIndex`` and
    ``MergedArtifact`` and, duck-typed with no import, the JAX package's
    (the parity tests feed one index to both packages)."""

    h: int
    kw: int
    eu: int
    ed: int
    max_bucket: int
    n_colors: int
    NB: int                 # bucket rows (host int)
    bloom_log: int
    cuckoo_log: int
    bloom: torch.Tensor     # int32 [2^bloom_log], folded to <= 2^24 words
    cuckoo: torch.Tensor    # int32 [2^cuckoo_log, 12] keys|starts|counts
    erec: torch.Tensor      # int32 [E, kw+1] key words + (length|color<<16)
    prec: torch.Tensor      # int32 [E, 3] (gid, rid1, rid2)

    @classmethod
    def from_merged(cls, m: MergedIndex, device) -> "TorchMergedIndex":
        erec, _, prec = _fused_records(
            m.key_words, m.length, m.color, m.bucket_start, m.bucket_count,
            m.gid, m.rid1, m.rid2)
        bloom, blog = _build_bloom(np.asarray(m.pref_lo))
        ck, cklog = _build_cuckoo(m.pref_lo, m.bucket_start, m.bucket_count)
        return cls._make(m, m.pref_lo.shape[0], bloom, blog, ck, cklog, erec,
                         prec, device)

    @classmethod
    def from_artifact(cls, a, device) -> "TorchMergedIndex":
        """From a ``MergedArtifact``: memmapped arrays go straight to the
        device.  A missing bloom or cuckoo table is built in memory; the
        artifact is never written."""
        if a.bloom is not None:
            bloom, blog = np.asarray(a.bloom), a.bloom_log
        else:
            bloom, blog = _build_bloom(np.asarray(a.pref_lo))
        if a.cuckoo is not None:
            ck, cklog = a.cuckoo, a.cuckoo_log
        else:
            brec = np.asarray(a.brec)
            ck, cklog = _build_cuckoo(np.asarray(a.pref_lo), brec[:, 0],
                                      brec[:, 1])
        return cls._make(a, a.NB, bloom, blog, ck, cklog, a.erec, a.prec,
                         device)

    @classmethod
    def _make(cls, src, NB, bloom, blog, ck, cklog, erec, prec, device):
        if blog > BLOOM_DEVICE_LOG:
            bloom, blog = _fold_bloom(bloom, BLOOM_DEVICE_LOG)
        return cls(
            h=src.h, kw=src.kw, eu=src.eu, ed=src.ed,
            max_bucket=src.max_bucket, n_colors=src.n_colors, NB=int(NB),
            bloom_log=int(blog), cuckoo_log=int(cklog),
            bloom=_as_i32(bloom, device), cuckoo=_as_i32(ck, device),
            erec=_as_i32(erec, device), prec=_as_i32(prec, device))

    @property
    def device(self) -> torch.device:
        return self.erec.device


class Matches(NamedTuple):
    """Distinct-capable match rows sorted by (read, gid), plus the slots."""

    slots: MatchSlots
    read: torch.Tensor       # int64 [M] read of each match row
    gid: torch.Tensor        # int32 [M] global entry id
    distinct: torch.Tensor   # bool [M] first row of its (read, gid)
    overflow_slots: torch.Tensor   # int32 [] distinct matches beyond maxm


def collect_matches(dm: TorchMergedIndex, codes: torch.Tensor,
                    lengths: torch.Tensor, maxm: int) -> Matches:
    """int8 codes [B, Lp], int32 lengths [B] -> Matches with [B, maxm]
    slots (``MatchSlots`` of ``collect_matches_sortjoin``)."""
    B, Lp = codes.shape
    O = num_offsets(Lp, dm.h)
    dev = codes.device
    maybe, khlo = probe_bloom(codes, dm.bloom, dm.h, dm.bloom_log)
    rows = torch.nonzero(maybe).squeeze(1)           # host sync: live count
    found = cuckoo_verify(rows, khlo, codes, lengths, dm.cuckoo,
                          dm.cuckoo_log, dm.erec, dm.n_colors)
    fi, _ = torch.nonzero(found >= 0, as_tuple=True)
    e = found[found >= 0].to(torch.int64)
    read = rows[fi] // O
    pr = dm.prec[e]                                   # [M, 3]
    key = (read << 31) | pr[:, 0].to(torch.int64)
    key, order = torch.sort(key)
    pr = pr[order]
    read = key >> 31
    gid = pr[:, 0].contiguous()
    M = key.shape[0]
    distinct = torch.ones(M, dtype=torch.bool, device=dev)
    distinct[1:] = key[1:] != key[:-1]
    newread = torch.ones(M, dtype=torch.bool, device=dev)
    newread[1:] = read[1:] != read[:-1]
    # rank among the read's distinct rows (sortjoin.py:1290-1295)
    dint = distinct.to(torch.int32)
    before = torch.cumsum(dint, 0, dtype=torch.int32) - dint
    (dstart,) = first_of_run_scan(newread, before)
    rank = before - dstart
    put = distinct & (rank < maxm)
    overflow = (distinct & (rank >= maxm)).sum(dtype=torch.int32)
    flat = torch.where(put, read * maxm + rank, B * maxm)

    def scatter(fill, vals):
        out = torch.full((B * maxm + 1,), fill, dtype=torch.int32, device=dev)
        out[flat] = vals                              # row B*maxm: dump slot
        return out[:B * maxm].reshape(B, maxm)

    slots = scatter(BIG, gid)
    ms = MatchSlots(slots=slots, rid1=scatter(0, pr[:, 1]),
                    rid2=scatter(0, pr[:, 2]),
                    in_u=(slots < BIG) & (slots < dm.eu))
    return Matches(ms, read, gid, distinct, overflow)


class BatchCounts(NamedTuple):
    cnts_u: torch.Tensor    # int32 [G]
    cnts_d: torch.Tensor    # int32 [G]
    nundet: torch.Tensor    # int32 []
    nconf: torch.Tensor     # int32 []
    overflow_slots: torch.Tensor   # int32 []
    pair_lo: torch.Tensor   # int32 [B] assigned pair (sc mode) or -1
    pair_hi: torch.Tensor   # int32 [B]


def classify_batch(dm: TorchMergedIndex, codes: torch.Tensor,
                   lengths: torch.Tensor, num_genome_slots: int, maxm: int,
                   rcount: torch.Tensor | None = None,
                   sc_mode: bool = False) -> BatchCounts:
    """Collect + case analysis for one batch.

    ``rcount`` (int32 [eu+ed+1], last slot a dump) is the pass
    accumulator: rcount[e] += 1 for every distinct (read, entry) of an
    assigned read, added in place (``part2``, sortjoin.py:1346-1359).
    ``sc_mode`` fills ``pair_lo/pair_hi`` with each read's assigned
    genome pair (case_analysis); the JAX session takes no rcount then."""
    mt = collect_matches(dm, codes, lengths, maxm)
    case = case_analysis(mt.slots, lengths, num_genome_slots, sc_mode=sc_mode)
    if rcount is not None:
        ok = mt.distinct & case.assigned[mt.read]
        tgt = torch.where(ok, mt.gid.to(torch.int64), rcount.shape[0] - 1)
        rcount.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))
    return BatchCounts(case.cnts_u, case.cnts_d, case.nundet, case.nconf,
                       mt.overflow_slots, case.pair_lo, case.pair_hi)
