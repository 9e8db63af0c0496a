"""Distributed query over a ``data x model`` grid of ranks: the
counterpart of ``cammiq_tpu/parallel/dist_query.py``'s sort-join half
(``_MergedSource``, ``shard_merged_cuts``, ``build_fused_shard``,
``DistSortJoinSession``, 201-620), the one distributed design both
packages' CLIs run (a grid takes the sort join whatever the engine).

- Reads: each rank takes its contiguous ``1/data`` of every batch.
- Index: the merged index is cut into ``model`` bucket-aligned shards of
  about equal entry counts; the rank at model index ``m`` holds shard
  ``m`` only, padded to the shape every shard shares, as a
  ``TorchMergedIndex``.  A rank builds only its own shard: from an
  artifact it reads only that shard's pages of the memmaps.
- Per batch, inside a row of the grid (a model group): ``collect_matches``
  of the rank's reads against its shard through the three query kernels,
  then ONE ``all_gather_into_tensor`` of the ``[b, maxm]`` slots, rid1 and
  rid2, giving every rank of the row ``[b, model * maxm]`` slots (slot ids
  are global entry ids, so the gathered slots are the reads' matches in
  the whole index).  The row's lead (model index 0) runs ``case_count``
  on them (one kernel launch: the counts and the rcount); the other ranks
  only probe.  Shapes are fixed and nothing waits on the host, so a grid
  batch makes no host sync.
- Per pass, the session (``query/pipeline.py``) sums its one counter
  buffer over the grid with one ``all_reduce``.

rcount comes from the gathered slots (``case_count``: the distinct slots
of the assigned reads), as ``cammiq_tpu``'s ``rcounts_from_case`` does,
and not from each shard's own match rows: an entry and its
reverse-complement twin share one global id and may sit in two shards, so
a read that holds both would be counted once per shard.

The shard builders are copies of the JAX package's numpy code on this
package's ``query/merged.py`` builders.  The port's cuckoo span table keeps
its 12-word rows for every ``max_bucket`` (``cuckoo_verify``), so the
8-word form (``_cuckoo_kv_from_table``) is not built; nor is the bucket
directory (``dir_start``, ``_shard_dir_steps``), which only the JAX
package's dir and sort joins read.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..query.classify import BatchCounts, MatchSlots, case_count
from ..query.merged import (BLOOM_LOG_WORDS, NEVER_LEN, _build_bloom,
                            _build_cuckoo, _fused_records)
from ..query.sortjoin import TorchMergedIndex, collect_matches
from .mesh import ProcessGrid


@dataclasses.dataclass
class _MergedSource:
    """Uniform fused-record view over a MergedIndex (host arrays) or a
    MergedArtifact (memmaps): the shard builder slices these lazily, so a
    process only ever materializes ITS shards' pages."""

    h: int
    kw: int
    eu: int
    ed: int
    max_bucket: int
    n_colors: int
    E: int
    NB: int
    erec: np.ndarray       # uint32 [E, kw+1]
    prec: np.ndarray       # int32 [E, 3]
    pref_lo: np.ndarray    # uint32 [NB]
    pref_hi: np.ndarray    # uint32 [NB]
    bucket_start: np.ndarray
    bucket_count: np.ndarray

    @classmethod
    def from_merged(cls, m) -> "_MergedSource":
        erec, brec, prec = _fused_records(
            m.key_words, m.length, m.color, m.bucket_start, m.bucket_count,
            m.gid, m.rid1, m.rid2,
        )
        return cls(h=m.h, kw=m.kw, eu=m.eu, ed=m.ed,
                   max_bucket=m.max_bucket, n_colors=m.n_colors,
                   E=int(m.length.shape[0]), NB=int(m.pref_lo.shape[0]),
                   erec=erec, prec=prec,
                   pref_lo=m.pref_lo, pref_hi=m.pref_hi,
                   bucket_start=m.bucket_start, bucket_count=m.bucket_count)

    @classmethod
    def from_artifact(cls, a) -> "_MergedSource":
        return cls(h=a.h, kw=a.kw, eu=a.eu, ed=a.ed,
                   max_bucket=a.max_bucket, n_colors=a.n_colors,
                   E=a.E, NB=a.NB,
                   erec=a.erec, prec=a.prec,
                   pref_lo=a.pref_lo, pref_hi=a.pref_hi,
                   bucket_start=a.brec[:, 0], bucket_count=a.brec[:, 1])


def shard_merged_cuts(src: _MergedSource, mp: int):
    """Bucket-aligned equal-entry shard cuts.  Returns (cuts_b, e_lo, e_hi,
    e_pad, nb_pad, bloom_log, ck_log).  Padded bucket rows carry
    bucket_count=0 and the key 0xFFFFFFFF, so they can never shadow a real
    bucket; padded entries use the never-matching erec length."""
    NB, E = src.NB, src.E
    # equal-ENTRY cuts (entries dominate shard memory; equal-bucket cuts
    # pad every shard to the most entry-heavy one on skewed indexes)
    bs = np.asarray(src.bucket_start)
    cuts_b = [0] + [
        int(np.searchsorted(bs, E * i // mp, side="left"))
        for i in range(1, mp)
    ] + [NB]
    for i in range(1, mp):
        cuts_b[i] = min(max(cuts_b[i], cuts_b[i - 1]), NB)
    # snap cuts forward so bucket rows sharing one entry span (hash
    # collisions merged by hlo) never split across shards
    for i in range(1, mp):
        c = cuts_b[i]
        while 0 < c < NB and src.bucket_start[c] == src.bucket_start[c - 1]:
            c += 1
        cuts_b[i] = min(max(c, cuts_b[i - 1]), NB)
    nb_pad = max(1, max(cuts_b[i + 1] - cuts_b[i] for i in range(mp)))
    e_lo = [int(src.bucket_start[cuts_b[i]]) if cuts_b[i] < NB else E
            for i in range(mp)]
    e_hi = e_lo[1:] + [E]
    e_pad = max(1, max(h - l for l, h in zip(e_lo, e_hi)))
    # per-shard blocked bloom (see merged._build_bloom); the log size is
    # shared across shards, so every rank derives the same shapes.  Capped
    # at BLOOM_LOG_WORDS; the device copy folds to BLOOM_DEVICE_LOG
    # (TorchMergedIndex._make).
    bloom_log = min(max(int(nb_pad).bit_length(), 12), BLOOM_LOG_WORDS)
    # per-shard cuckoo span table at load <= 0.4, its size derived from the
    # shard geometry alone; _build_cuckoo raises on the ~impossible
    # fixed-size placement failure
    ck_log = max(int(np.ceil(np.log2(max(nb_pad, 2) / 1.6))), 10)
    return cuts_b, e_lo, e_hi, e_pad, nb_pad, bloom_log, ck_log


def build_fused_shard(src: _MergedSource, i: int, cuts_b, e_lo, e_hi,
                      e_pad: int, nb_pad: int, bloom_log: int,
                      ck_log: int) -> dict:
    """Materialize shard i's padded fused-record arrays (one host slice
    per array - with a memmap source this faults in only shard i's pages),
    its bloom filter and its cuckoo span table."""
    kw1 = src.erec.shape[1]
    erec = np.zeros((e_pad, kw1), np.uint32)
    erec[:, kw1 - 1] = np.uint32(NEVER_LEN)
    prec = np.zeros((e_pad, 3), np.int32)
    pref_lo = np.full(nb_pad, 0xFFFFFFFF, np.uint32)
    pref_hi = np.full(nb_pad, 0xFFFFFFFF, np.uint32)
    brec = np.zeros((nb_pad, 2), np.int32)
    blo, bhi = cuts_b[i], cuts_b[i + 1]
    lo, hi = e_lo[i], e_hi[i]
    ec, bc = hi - lo, bhi - blo
    if ec:
        erec[:ec] = src.erec[lo:hi]
        prec[:ec] = src.prec[lo:hi]
    if bc:
        pref_lo[:bc] = src.pref_lo[blo:bhi]
        pref_hi[:bc] = src.pref_hi[blo:bhi]
        brec[:bc, 0] = np.asarray(src.bucket_start[blo:bhi], np.int64) - lo
        brec[:bc, 1] = src.bucket_count[blo:bhi]
    out = dict(erec=erec, prec=prec, pref_lo=pref_lo, pref_hi=pref_hi,
               brec=brec)
    # pads (0xFFFFFFFF rows) enter the filter too: a probe matching a pad
    # can only be a false positive, and pads carry a (0, 0) span
    out["bloom"] = _build_bloom(pref_lo, log_words=bloom_log)[0]
    # real rows only: the pad key (0xFFFFFFFF, count 0) would read as
    # empty anyway, and bc rows are what the search must resolve
    out["cuckoo"] = _build_cuckoo(pref_lo[:max(bc, 1)], brec[:max(bc, 1), 0],
                                  brec[:max(bc, 1), 1], tlog=ck_log)[0]
    return out


def shard_index(src: _MergedSource, i: int, cuts, device) -> TorchMergedIndex:
    """Shard i (of ``cuts = shard_merged_cuts(src, mp)``) on ``device``."""
    _, _, _, _, nb_pad, bloom_log, ck_log = cuts
    sh = build_fused_shard(src, i, *cuts)
    return TorchMergedIndex._make(src, nb_pad, sh["bloom"], bloom_log,
                                  sh["cuckoo"], ck_log, sh["erec"], sh["prec"],
                                  device)


def gather_slots(grid: ProcessGrid, ms: MatchSlots, u_end: int) -> MatchSlots:
    """[b, S] slots of every rank of the grid's row -> [b, model * S], rank
    m's in columns [m * S, (m + 1) * S) (JAX's tiled ``all_gather`` on axis
    1): one collective for slots, rid1 and rid2; ``in_u`` is recomputed as
    ``slots < u_end`` (every unique id lies below every doubly id)."""
    mp = grid.model
    b, S = ms.slots.shape
    local = torch.stack([ms.slots, ms.rid1, ms.rid2])          # [3, b, S]
    out = local.new_empty((mp * 3, b, S))
    dist.all_gather_into_tensor(out, local, group=grid.model_group)
    out = out.view(mp, 3, b, S).permute(1, 2, 0, 3).reshape(3, b, mp * S)
    slots, rid1, rid2 = out.unbind(0)
    return MatchSlots(slots, rid1, rid2, in_u=slots < u_end)


class DistSortJoinSession:
    """One rank's part of the distributed sort-join classify: its index
    shard on its device and the per-batch step of its grid row."""

    def __init__(self, grid: ProcessGrid, src: _MergedSource, device):
        device = torch.device(device)
        if not grid.active:
            raise ValueError(f"rank {grid.rank} is outside the {grid.data}x"
                             f"{grid.model} grid")
        if device.type != grid.device.type:
            raise ValueError(f"a session on {device} in a grid on {grid.device}")
        self.grid = grid
        mp = grid.model
        cuts = shard_merged_cuts(src, mp)
        _, e_lo, e_hi, e_pad, nb_pad, bloom_log, ck_log = cuts
        self.geometry = dict(e_pad=e_pad, nb_pad=nb_pad, bloom_log=bloom_log,
                             ck_log=ck_log,
                             entries=[e_hi[i] - e_lo[i] for i in range(mp)])
        self.dm = shard_index(src, grid.model_index, cuts, device)
        if mp > 1 and grid.rank == 0:
            sizes = self.geometry["entries"]
            print(
                f"[dist] model shards: {mp} x {e_pad} entries (pad), "
                f"utilization min {min(sizes) / max(e_pad, 1):.2f} / max "
                f"{max(sizes) / max(e_pad, 1):.2f}, buckets pad {nb_pad}",
                file=sys.stderr,
            )

    @classmethod
    def from_merged(cls, grid, merged, device):
        return cls(grid, _MergedSource.from_merged(merged), device)

    @classmethod
    def from_artifact(cls, grid, artifact, device):
        return cls(grid, _MergedSource.from_artifact(artifact), device)

    def gather(self, ms: MatchSlots) -> MatchSlots:
        return gather_slots(self.grid, ms, self.dm.eu)

    def classify_batch(self, codes: torch.Tensor, lengths: torch.Tensor,
                       num_genome_slots: int, maxm: int,
                       rcount: torch.Tensor | None = None,
                       sc_mode: bool = False, frac: int = 0,
                       counts: torch.Tensor | None = None,
                       probe_counts: torch.Tensor | None = None) -> BatchCounts:
        """``sortjoin.classify_batch`` for this rank's reads (``b`` rows of
        the global batch) against its shard, with the row's slots
        gathered.  Every rank of the row must call it with the same
        ``maxm`` and shapes.  On the row's lead the result is the reads'
        counts (added to ``counts`` when given) and ``rcount`` gets the
        distinct entries of each assigned read; elsewhere only the overflow
        counts are set (the other fields are None) and neither ``counts``
        nor ``rcount`` is touched.  ``probe_counts`` gets this rank's
        probe counts (``collect_matches``)."""
        mt = collect_matches(self.dm, codes, lengths, maxm, frac, probe_counts)
        slots = self.gather(mt.slots)
        if self.grid.model_index:
            return BatchCounts(None, None, None, None, mt.overflow_slots,
                               mt.overflow_hits, None, None)
        cc = case_count(slots, lengths, num_genome_slots, sc_mode=sc_mode,
                        rcount=rcount, counts=counts)
        return BatchCounts(cc.cnts_u, cc.cnts_d, cc.nundet, cc.nconf,
                           mt.overflow_slots, mt.overflow_hits, cc.pair_lo,
                           cc.pair_hi)

