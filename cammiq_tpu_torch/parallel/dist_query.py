"""Distributed query over a ``data x model`` grid of ranks: the
counterpart of ``cammiq_tpu/parallel/dist_query.py``, its sort-join half
(``_MergedSource``, ``shard_merged_cuts``, ``build_fused_shard``,
``DistSortJoinSession``, 201-620) and its gather half (``ShardedIndex``,
``shard_flat_index``, ``DistQuerySession``, 35-198 and 623-737).

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

The gather engine's twin, ``DistQuerySession``, shards each FlatIndex
into ``model`` bucket-aligned pieces (``shard_flat_index``, a copy of the
JAX numpy code, a hash table of one shared size rebuilt per shard).  The
rank at model index ``m`` holds shard ``m`` of both tables as
``DeviceIndex`` tensors and probes its ``1/data`` of each batch with the
ids ``u_base = m * Eu_pad`` and ``d_base = model * Eu_pad + m * Ed_pad``
(``Eu_pad``, ``Ed_pad``: the tables' padded shard lengths); the row
gathers the ``[3, b, 4 O]`` slots in one collective and every rank of it
runs ``case_count`` once, its counts and the rcounts of its own two id
ranges written straight into the buffer the column reduces.
``classify`` returns the batch's counts on the host, the same on every
rank, with rcounts mapped back to entry order through ``orig_id``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..index.table import FlatIndex, _empty_flat_index, hash_prefix
from ..query import classify
from ..query.classify import BatchCounts, MatchSlots, case_count
from ..query.merged import (BLOOM_LOG_WORDS, NEVER_LEN, _build_bloom,
                            _build_cuckoo, _fused_records)
from ..query.probe import DeviceIndex, stage_index
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
                       counts: torch.Tensor | None = None) -> BatchCounts:
        """``sortjoin.classify_batch`` for this rank's reads (``b`` rows of
        the global batch) against its shard, with the row's slots
        gathered.  Every rank of the row must call it with the same
        ``maxm`` and shapes.  On the row's lead the result is the reads'
        counts (added to ``counts`` when given) and ``rcount`` gets the
        distinct entries of each assigned read; elsewhere only the overflow
        counts are set (the other fields are None) and neither ``counts``
        nor ``rcount`` is touched."""
        mt = collect_matches(self.dm, codes, lengths, maxm, frac)
        slots = self.gather(mt.slots)
        if self.grid.model_index:
            return BatchCounts(None, None, None, None, mt.overflow_slots,
                               mt.overflow_hits, None, None)
        cc = case_count(slots, lengths, num_genome_slots, sc_mode=sc_mode,
                        rcounts=() if rcount is None else ((rcount, 0),),
                        counts=counts)
        return BatchCounts(cc.cnts_u, cc.cnts_d, cc.nundet, cc.nconf,
                           mt.overflow_slots, mt.overflow_hits, cc.pair_lo,
                           cc.pair_hi)


# ---- the gather engine's twin: copies of the JAX package's FlatIndex
# sharding (cammiq_tpu/parallel/dist_query.py:34-168)

@dataclasses.dataclass
class ShardedIndex:
    """A FlatIndex split into `mp` equal-shape shards (stacked arrays)."""

    h: int
    kw: int
    mp: int
    e_pad: int                 # entries per shard (padded)
    max_probes: int
    max_bucket: int
    key_words: np.ndarray      # uint32 [mp, e_pad, kw]
    length: np.ndarray         # int32 [mp, e_pad]
    rid1: np.ndarray
    rid2: np.ndarray
    ucount1: np.ndarray
    ucount2: np.ndarray
    table_lo: np.ndarray       # uint32 [mp, T]
    table_hi: np.ndarray
    table_start: np.ndarray
    table_count: np.ndarray
    orig_id: np.ndarray        # int32 [mp, e_pad] original entry id or -1


def shard_flat_index(idx: FlatIndex, mp: int, load_factor: float = 0.5) -> ShardedIndex:
    """Split bucket-sorted entries into mp contiguous bucket-aligned
    chunks, rebuild a same-size hash table per shard."""
    E = idx.num_entries
    # bucket boundaries in the entry array
    if E:
        plo, phi = _entry_prefixes(idx)
        newb = np.ones(E, dtype=bool)
        newb[1:] = (plo[1:] != plo[:-1]) | (phi[1:] != phi[:-1])
        bstart = np.nonzero(newb)[0]
    else:
        plo = phi = np.zeros(0, np.uint32)
        bstart = np.zeros(0, np.int64)
    nb = len(bstart)

    # contiguous bucket ranges with ~equal entries
    cuts = [0]
    for m in range(1, mp):
        target = E * m // mp
        bi = int(np.searchsorted(bstart, target, side="left"))
        cuts.append(int(bstart[bi]) if bi < nb else E)
    cuts.append(E)

    shards: List[dict] = []
    e_pad = 1
    t_size = 8
    probes = 1
    maxb = 1
    for m in range(mp):
        lo, hi = cuts[m], cuts[m + 1]
        cnt = hi - lo
        e_pad = max(e_pad, cnt)
        shards.append({"lo": lo, "hi": hi})
    # shared table size
    max_buckets = 1
    for m in range(mp):
        lo, hi = shards[m]["lo"], shards[m]["hi"]
        if hi > lo:
            nb_m = int(np.sum((bstart >= lo) & (bstart < hi)))
            max_buckets = max(max_buckets, nb_m)
    while t_size < max_buckets / load_factor:
        t_size *= 2

    out = ShardedIndex(
        h=idx.h, kw=idx.kw, mp=mp, e_pad=e_pad,
        max_probes=1, max_bucket=max(1, idx.max_bucket),
        key_words=np.zeros((mp, e_pad, idx.kw), np.uint32),
        length=np.full((mp, e_pad), 1 << 30, np.int32),
        rid1=np.zeros((mp, e_pad), np.int32),
        rid2=np.zeros((mp, e_pad), np.int32),
        ucount1=np.zeros((mp, e_pad), np.int32),
        ucount2=np.zeros((mp, e_pad), np.int32),
        table_lo=np.zeros((mp, t_size), np.uint32),
        table_hi=np.zeros((mp, t_size), np.uint32),
        table_start=np.full((mp, t_size), -1, np.int32),
        table_count=np.zeros((mp, t_size), np.int32),
        orig_id=np.full((mp, e_pad), -1, np.int32),
    )

    from ..index.table import _assign_slots

    # vectorized per-shard slot assignment; grow the (shared) table size
    # until every shard fits with bounded displacement
    shard_slots = None
    while True:
        shard_slots = []
        ok = True
        for m in range(mp):
            lo, hi = shards[m]["lo"], shards[m]["hi"]
            bsel = (bstart >= lo) & (bstart < hi)
            hv = hash_prefix(plo[bstart[bsel]], phi[bstart[bsel]]).astype(np.int64) & (t_size - 1)
            slots, disp = _assign_slots(hv, t_size)
            if slots is None:
                ok = False
                break
            shard_slots.append((bsel, slots, disp))
        if ok:
            break
        t_size *= 2
        out.table_lo = np.zeros((mp, t_size), np.uint32)
        out.table_hi = np.zeros((mp, t_size), np.uint32)
        out.table_start = np.full((mp, t_size), -1, np.int32)
        out.table_count = np.zeros((mp, t_size), np.int32)

    for m in range(mp):
        lo, hi = shards[m]["lo"], shards[m]["hi"]
        cnt = hi - lo
        if cnt == 0:
            continue
        out.key_words[m, :cnt] = idx.key_words[lo:hi]
        out.length[m, :cnt] = idx.length[lo:hi]
        out.rid1[m, :cnt] = idx.rid1[lo:hi]
        out.rid2[m, :cnt] = idx.rid2[lo:hi]
        out.ucount1[m, :cnt] = idx.ucount1[lo:hi]
        out.ucount2[m, :cnt] = idx.ucount2[lo:hi]
        out.orig_id[m, :cnt] = np.arange(lo, hi, dtype=np.int32)
        bsel, slots, disp = shard_slots[m]
        bs = bstart[bsel] - lo
        bc = np.diff(np.concatenate([bs, [cnt]]))
        out.table_lo[m, slots] = plo[bstart[bsel]]
        out.table_hi[m, slots] = phi[bstart[bsel]]
        out.table_start[m, slots] = bs
        out.table_count[m, slots] = bc
        probes = max(probes, disp + 1)
    out.max_probes = probes
    return out


def _entry_prefixes(idx: FlatIndex) -> Tuple[np.ndarray, np.ndarray]:
    from ..index.table import _prefix_lo_hi

    return _prefix_lo_hi(idx.key_words, idx.h)



def _local_didx(sh: dict, h, kw, max_probes, max_bucket, device) -> DeviceIndex:
    """A DeviceIndex of one shard's blocks (``_shard_arrays`` at one model
    index) on ``device``."""
    return stage_index(
        h, kw, max_probes, max_bucket, int(sh["length"].shape[-1]),
        sh["key_words"], sh["length"], sh["rid1"], sh["rid2"], sh["ucount1"],
        sh["ucount2"], sh["table_lo"], sh["table_hi"], sh["table_start"],
        sh["table_count"], device)


def _shard_arrays(s: ShardedIndex) -> dict:
    return {
        "key_words": s.key_words, "length": s.length,
        "rid1": s.rid1, "rid2": s.rid2,
        "ucount1": s.ucount1, "ucount2": s.ucount2,
        "table_lo": s.table_lo, "table_hi": s.table_hi,
        "table_start": s.table_start, "table_count": s.table_count,
    }


class HostBatchCounts(NamedTuple):
    """A batch's counts on the host: the fields of the JAX package's
    ``classify.BatchCounts``."""

    cnts_u: np.ndarray      # int32 [G]
    cnts_d: np.ndarray      # int32 [G]
    rcount_u: np.ndarray    # int64 [Eu] per unique-index entry
    rcount_d: np.ndarray    # int64 [Ed]
    nundet: int
    nconf: int
    pair_lo: np.ndarray     # int32 [B] assigned pair (sc mode) or -1
    pair_hi: np.ndarray     # int32 [B]


class DistQuerySession:
    """Distributed gather classify over a ``ProcessGrid``: this rank's
    shard of both FlatIndex tables on its device and the batch step of its
    row and column."""

    def __init__(self, grid: ProcessGrid, index_u: FlatIndex,
                 index_d: Optional[FlatIndex], num_genome_slots: int,
                 sc_mode: bool = False, device="cuda"):
        device = resolve_device(device)
        if not grid.active:
            raise ValueError(f"rank {grid.rank} is outside the {grid.data}x"
                             f"{grid.model} grid")
        if device.type != grid.device.type:
            raise ValueError(f"a session on {device} in a grid on {grid.device}")
        self.grid = grid
        self.G = num_genome_slots
        self.mp, self.dp = grid.model, grid.data
        self.sc_mode = sc_mode
        if index_d is None:
            # what the JAX session builds: an empty selection at Lmax 32
            index_d = _empty_flat_index(index_u.h, 2, True)
        self.su = shard_flat_index(index_u, self.mp)
        self.sd = shard_flat_index(index_d, self.mp)
        self.index_u, self.index_d = index_u, index_d
        m = grid.model_index
        self.didx_u, self.didx_d = (
            _local_didx({k: v[m] for k, v in _shard_arrays(s).items()}, s.h,
                        s.kw, s.max_probes, s.max_bucket, device)
            for s in (self.su, self.sd))
        Eu_pad, Ed_pad = self.su.e_pad, self.sd.e_pad
        self.u_base = m * Eu_pad
        self.d_base = self.mp * Eu_pad + m * Ed_pad
        self.device = device

    def classify(self, codes: np.ndarray, lengths: np.ndarray) -> HostBatchCounts:
        """codes [B, Lp] with B divisible by ``data``, the whole batch on
        every rank.  Returns host counts with rcounts mapped back to the
        original entry order, the same on every rank."""
        B = codes.shape[0]
        if B % self.dp:
            raise ValueError(f"batch of {B} reads over {self.dp} data ranks")
        grid, G, dev, su, sd = self.grid, self.G, self.device, self.su, self.sd
        rows = grid.data_slice(B)
        c = torch.from_numpy(np.ascontiguousarray(codes[rows], np.int8)).to(dev)
        ln = torch.from_numpy(np.ascontiguousarray(lengths[rows], np.int32)).to(dev)
        # this rank's rows against its shard, the row's slots gathered: the
        # case analysis is the same on every rank of the row
        ms = classify.collect_matches(self.didx_u, self.didx_d, c, ln,
                                      self.u_base, self.d_base)
        E2 = su.e_pad + sd.e_pad
        # the counts, and the rcounts over this rank's two id ranges, in
        # one buffer summed over the column
        buf = torch.zeros(2 * G + 2 + E2, dtype=torch.int32, device=dev)
        rc = buf[2 * G + 2:]
        cc = case_count(gather_slots(grid, ms, self.mp * su.e_pad), ln, G,
                        sc_mode=self.sc_mode, counts=buf[:2 * G + 2],
                        rcounts=((rc[:su.e_pad], self.u_base),
                                 (rc[su.e_pad:], self.d_base)))
        dist.all_reduce(buf, group=grid.data_group)
        rc_all = buf.new_empty(self.mp * E2)
        dist.all_gather_into_tensor(rc_all, rc, group=grid.model_group)
        pairs = torch.stack([cc.pair_lo, cc.pair_hi])
        pairs_all = pairs.new_empty((self.dp * 2, pairs.shape[1]))
        dist.all_gather_into_tensor(pairs_all, pairs, group=grid.data_group)
        pairs_all = pairs_all.view(self.dp, 2, -1).permute(1, 0, 2).reshape(2, -1)
        host = buf.cpu().numpy()
        rc_all = rc_all.view(self.mp, E2).cpu().numpy()
        pair_lo, pair_hi = pairs_all.cpu().numpy()
        rcount_u = np.zeros(self.index_u.num_entries, np.int64)
        rcount_d = np.zeros(self.index_d.num_entries, np.int64)
        for rcount, s, part in ((rcount_u, su, rc_all[:, :su.e_pad]),
                                (rcount_d, sd, rc_all[:, su.e_pad:])):
            sel = s.orig_id >= 0
            rcount[s.orig_id[sel]] = part[sel]
        return HostBatchCounts(
            cnts_u=host[:G], cnts_d=host[G:2 * G], rcount_u=rcount_u,
            rcount_d=rcount_d, nundet=int(host[2 * G]), nconf=int(host[2 * G + 1]),
            pair_lo=pair_lo, pair_hi=pair_hi)
