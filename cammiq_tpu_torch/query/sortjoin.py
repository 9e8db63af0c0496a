"""Bloom -> cuckoo probe join on torch tensors (the query hot loop).

Port of the production path of ``cammiq_tpu/query/sortjoin.py``
(``collect_matches_sortjoin`` with ``join='bloom'``, 822-1310, and
``make_sortjoin_classifier``, 1313-1385).  The merged, RC-augmented,
chain-colored index is built on the host (``query/merged.py``); this
module carries it to the device and probes the forward strand only (see
``cammiq_tpu/query/sortjoin.py``'s docstring for why that is exact).

Per batch, on fixed shapes and with no host sync:
  1. kernel 2 (``probe_bloom``): prefix hash + bloom test for every
     (read, offset) row, compacted on the device to the maybe rows in
     order, their keys and their count; where the bloom is larger than
     the card's L2 holds, a fold of it that the L2 holds is tested first
     (``level1_log``), and only its passers read the bloom;
  2. kernel 3 (``cuckoo_verify``): exact span lookup + bucket scan over
     the survivors (count read on the device), appending (row, entry)
     matches to a list of static capacity KP (``match_capacity``: the
     JAX path's K and KP from ``hit_capacity_frac``), with the matches
     beyond it counted as ``overflow_hits``;
  3. kernel 5 (``match_assemble``): the match list grouped by read (a
     bucket a read), each read's distinct gids sorted and ranked, the
     first maxm written to its row of the [B, maxm] slots with their
     ``prec`` payloads, every empty slot written, the distinct matches
     beyond maxm counted; one cooperative launch, reading the list's
     count on the device;
  4. kernel 4 (``case_count``): the case analysis of the slots and the
     rcount of each assigned read's distinct entries, one launch.
Slot overflow (more than maxm distinct matches in a read) and hit
overflow are counted on the device; the session widens maxm or KP and
re-runs the pass.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import u32
from ..kernels.cuckoo_verify import cuckoo_verify
from ..kernels.match_assemble import match_assemble
from ..kernels.probe_bloom import num_offsets, probe_bloom
from .classify import BatchCounts, MatchSlots, case_count
from .merged import (
    BLOOM_DEVICE_LOG,
    MergedIndex,
    _build_bloom,
    _build_cuckoo,
    _fold_bloom,
    _fused_records,
)


def level1_log(bloom_log: int, l2_bytes: int) -> int:
    """The log words of the bloom's level-1 fold: the largest power of two
    of 4-byte words within a third of the L2 (the rest stays for the
    batch's other kernels: its codes, match_assemble's buckets, the
    rcount lines it touches), or 0, no level 1, where the bloom is no
    larger than that or there is no L2 to hold it (``l2_bytes`` 0).  On
    the H100's 50 MB L2: 2^22 words, 16 MB."""
    log = (l2_bytes // 12).bit_length() - 1
    return log if 1 <= log < bloom_log else 0


def _as_i32(a: np.ndarray, device) -> torch.Tensor:
    """Host array (uint32 or int32, memmap allowed) -> int32 tensor on
    `device` carrying the same 32 bits."""
    return torch.from_numpy(u32.bits32(a).copy()).to(device)


@dataclasses.dataclass
class TorchMergedIndex:
    """The device arrays the probe path reads, plus its statics.  The
    bloom's level-1 fold (``bloom_l1``) is there only where the bloom is
    larger than ``level1_log``'s share of the card's L2.

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
    bloom_l1_log: int       # 0: no level 1
    bloom_l1: torch.Tensor | None   # int32 [2^bloom_l1_log], bloom folded
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
        artifact is never written.  The cuckoo build of a pre-cuckoo
        artifact (tens of seconds at a production index) is then paid at
        every session start: ``index/artifact.py:ensure_cuckoo`` persists
        the table once.  The JAX session falls back to its directory join
        there instead; this port has no directory join, and the table it
        builds gives the same counts."""
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
        """The device arrays; the level-1 fold is sized by ``level1_log``
        from the card's L2 (none on the CPU)."""
        if blog > BLOOM_DEVICE_LOG:
            bloom, blog = _fold_bloom(bloom, BLOOM_DEVICE_LOG)
        device = torch.device(device)
        l2 = (torch.cuda.get_device_properties(device).L2_cache_size
              if device.type == "cuda" else 0)
        l1_log = level1_log(int(blog), l2)
        l1 = _as_i32(_fold_bloom(bloom, l1_log)[0], device) if l1_log else None
        return cls(
            h=src.h, kw=src.kw, eu=src.eu, ed=src.ed,
            max_bucket=src.max_bucket, n_colors=src.n_colors, NB=int(NB),
            bloom_log=int(blog), cuckoo_log=int(cklog),
            bloom=_as_i32(bloom, device), bloom_l1_log=l1_log, bloom_l1=l1,
            cuckoo=_as_i32(ck, device),
            erec=_as_i32(erec, device), prec=_as_i32(prec, device))

    @property
    def device(self) -> torch.device:
        return self.erec.device


class Matches(NamedTuple):
    """A batch's [B, maxm] slots and its overflow counts."""

    slots: MatchSlots
    overflow_slots: torch.Tensor   # int32 [] distinct matches beyond maxm
    overflow_hits: torch.Tensor    # int32 [] matches beyond KP


# the JAX path's capacity constants (cammiq_tpu/query/sortjoin.py:929,
# 1267): K's floor, and KP's slack over K + K/4
HIT_FLOOR = 256
LIST_SLACK = 256


def match_capacity(N: int, n_colors: int, frac: int) -> int:
    """KP, the match-list capacity for N probe rows: the JAX path's
    K = N // hit_capacity_frac (at least HIT_FLOOR) and
    KP = K + K/4 + LIST_SLACK, capped at N * n_colors, the most matches
    N rows can give.  ``frac = 0`` takes that cap, which cannot
    overflow."""
    if frac == 0:
        return N * n_colors
    K = min(max(N // frac, HIT_FLOOR), N)
    return min(K + K // 4 + LIST_SLACK, N * n_colors)


def collect_matches(dm: TorchMergedIndex, codes: torch.Tensor,
                    lengths: torch.Tensor, maxm: int, frac: int = 0,
                    probe_counts: torch.Tensor | None = None) -> Matches:
    """int8 codes [B, Lp], int32 lengths [B] -> Matches with [B, maxm]
    slots (``MatchSlots`` of ``collect_matches_sortjoin``), the match list
    at capacity ``match_capacity(B * O, n_colors, frac)``.
    ``probe_counts`` (int32 [2]), when given, gets the probe's rows sent to
    the bloom (level 2) and its survivors added in place."""
    B, Lp = codes.shape
    O = num_offsets(Lp, dm.h)
    KP = match_capacity(B * O, dm.n_colors, frac)
    rows, keys, n = probe_bloom(codes, dm.bloom, dm.h, dm.bloom_log,
                                dm.bloom_l1, dm.bloom_l1_log, probe_counts)
    mrow, me, counts = cuckoo_verify(rows, keys, n, codes, lengths, dm.cuckoo,
                                     dm.cuckoo_log, dm.erec, dm.n_colors, KP)
    slots, rid1, rid2, in_u, overflow = match_assemble(
        mrow, me, counts, dm.prec, O, B, maxm, dm.eu)
    return Matches(MatchSlots(slots, rid1, rid2, in_u), overflow, counts[1])


def classify_batch(dm: TorchMergedIndex, codes: torch.Tensor,
                   lengths: torch.Tensor, num_genome_slots: int, maxm: int,
                   rcount: torch.Tensor | None = None,
                   sc_mode: bool = False, frac: int = 0,
                   counts: torch.Tensor | None = None,
                   probe_counts: torch.Tensor | None = None) -> BatchCounts:
    """Collect + case analysis for one batch (``case_count``: one launch
    on a CUDA device), with no host sync there.

    ``rcount`` (int32, at least eu + ed elements) is the pass accumulator:
    rcount[e] += 1 for every distinct entry e of an assigned read, added in
    place from its slots (``part2``, sortjoin.py:1346-1359, adds the same
    from the match list; the two agree on a batch whose slots did not
    overflow, and the session discards a pass that overflowed).
    ``sc_mode`` fills ``pair_lo/pair_hi`` with each read's assigned genome
    pair; the JAX session takes no rcount then.  ``frac`` sizes the match
    list (``match_capacity``).  ``counts`` (int32 [2G + 2]: cnts_u, cnts_d,
    nundet, nconf), when given, is a pass accumulator the batch's counts
    are added to in place, and the returned counts are its views;
    ``probe_counts`` is ``collect_matches``'."""
    mt = collect_matches(dm, codes, lengths, maxm, frac, probe_counts)
    cc = case_count(mt.slots, lengths, num_genome_slots, sc_mode=sc_mode,
                    rcount=rcount, counts=counts)
    return BatchCounts(cc.cnts_u, cc.cnts_d, cc.nundet, cc.nconf,
                       mt.overflow_slots, mt.overflow_hits, cc.pair_lo,
                       cc.pair_hi)
