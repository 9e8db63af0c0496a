"""Query session: classify read batches and accumulate counts on the device.

Port of ``cammiq_tpu/query/pipeline.py:QuerySession`` for the single-device
sort-join engine.  Counts accumulate in int32 tensors on the session's
device; the pass ends in ONE blocking transfer, which also reads the slot
overflow count.  On overflow the whole read set re-runs with ``maxm``
doubled, and the wider ``maxm`` sticks for later runs.

All three modes are ported: quantification (per-entry rcounts), Type-I
counts, and sc mode, whose per-pair counts feed Type-II identification.
sc mode reads the same pair table as the JAX session
(``cammiq_tpu/query/pipeline.py:_pair_keys``): the distinct unordered
(rid1, rid2) pairs of the doubly entries, taken from ``index_d`` for an
npz session or from the artifact's ``prec`` rows with ``gid >= eu``.  It is
built once per session on the host and kept on the device as one sorted
int64 key ``lo << 32 | hi`` per pair.

``QueryCounts`` is a copy of ``cammiq_tpu/query/pipeline.py:QueryCounts``.
The session takes this package's ``FlatIndex`` and ``MergedArtifact`` and,
duck-typed by their numpy attributes with no import, the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import QueryConfig
from ..device import resolve_device
from ..index.table import FlatIndex
from ..io.fastq import ReadSet
from ..utils.timing import Timings, stage_timer
from .merged import build_merged_index
from .sortjoin import TorchMergedIndex, classify_batch

MAXM_SEED = 16
MAXM_LIMIT = 4096


@dataclasses.dataclass
class QueryCounts:
    """Accumulated classification results for one query file."""

    cnts_u: np.ndarray      # int64 [G] read_cnts_u by species id
    cnts_d: np.ndarray      # int64 [G]
    rcount_u: np.ndarray    # int64 [Eu] per unique-index entry
    rcount_d: np.ndarray    # int64 [Ed]
    nundet: int
    nconf: int
    pair_counts: Dict[Tuple[int, int], int]
    num_reads: int
    mean_read_len: int      # integer mean, reference: tlengths/reads.size()


class QuerySession:
    """Holds the merged index on one device and classifies read sets."""

    def __init__(self, index_u: FlatIndex, index_d: Optional[FlatIndex],
                 num_genome_slots: int, cfg: QueryConfig | None = None,
                 device="cuda"):
        """From a FlatIndex pair (``.npz``): the merged index is built on
        the host with ``build_merged_index``."""
        if index_d is not None and index_d.h != index_u.h:
            raise ValueError("unique/doubly hash lengths must match at query time")
        dev = resolve_device(device)
        self._init(TorchMergedIndex.from_merged(
            build_merged_index(index_u, index_d), dev), num_genome_slots, cfg)
        if index_d is not None and index_d.num_entries:
            self._pair_src = (index_d.rid1, index_d.rid2)

    @classmethod
    def from_artifact(cls, artifact, num_genome_slots: int,
                      cfg: QueryConfig | None = None,
                      device="cuda") -> "QuerySession":
        """From a precomputed merged-index artifact (index/artifact.py)."""
        self = cls.__new__(cls)
        dev = resolve_device(device)
        self._init(TorchMergedIndex.from_artifact(artifact, dev),
                   num_genome_slots, cfg)
        if artifact.ed:
            prec = np.asarray(artifact.prec)
            dd = prec[prec[:, 0] >= artifact.eu]
            self._pair_src = (dd[:, 1], dd[:, 2])
        return self

    def _init(self, dm: TorchMergedIndex, num_genome_slots: int,
              cfg: QueryConfig | None) -> None:
        self.cfg = cfg or QueryConfig()
        self.dm = dm
        self.device = dm.device
        self.num_genome_slots = num_genome_slots
        self.num_entries_u = dm.eu
        self.num_entries_d = dm.ed
        self.maxm = MAXM_SEED
        self._pair_src = None       # host (rid1, rid2) of the doubly entries
        self._pair_keys_host = None  # int64 [P], sorted
        self._pair_keys = None       # the same on the device

    def pair_keys(self) -> torch.Tensor:
        """Sorted distinct ``lo << 32 | hi`` keys of every pair the doubly
        index can assign (case_pair always assigns a pair some doubly
        entry carries), built on the first sc-mode pass."""
        if self._pair_keys is None:
            keys = np.zeros(0, np.int64)
            if self._pair_src is not None:
                r1, r2 = (np.asarray(r, np.int64) for r in self._pair_src)
                keys = np.unique((np.minimum(r1, r2) << 32) | np.maximum(r1, r2))
            self._pair_keys_host = keys
            self._pair_keys = torch.from_numpy(keys).to(self.device)
        return self._pair_keys

    def _run_pass(self, reads: ReadSet, bs: int, with_rcounts: bool,
                  sc_mode: bool):
        """One pass over the reads; host dict of counts, or None after a
        slot overflow (maxm is then doubled)."""
        G = self.num_genome_slots
        dev = self.device
        etot = self.num_entries_u + self.num_entries_d
        pk = self.pair_keys() if sc_mode else None
        P = pk.shape[0] if sc_mode else 0
        acc = {
            "cnts_u": torch.zeros(G, dtype=torch.int32, device=dev),
            "cnts_d": torch.zeros(G, dtype=torch.int32, device=dev),
            "nundet": torch.zeros((), dtype=torch.int32, device=dev),
            "nconf": torch.zeros((), dtype=torch.int32, device=dev),
            "ovs": torch.zeros((), dtype=torch.int32, device=dev),
            # [P + 1]: the last slot is a dump for unassigned reads
            "pairacc": torch.zeros(P + 1, dtype=torch.int32, device=dev),
        }
        if with_rcounts:   # the largest copy of the pass: only when asked
            acc["rcount"] = torch.zeros(etot + 1, dtype=torch.int32, device=dev)
        for batch in reads.batches(bs):
            codes = torch.from_numpy(batch.codes).to(dev).contiguous()
            lengths = torch.from_numpy(batch.lengths.astype(np.int32)).to(dev)
            out = classify_batch(self.dm, codes, lengths, G,
                                 self.maxm,
                                 acc.get("rcount"),
                                 sc_mode=sc_mode)
            if P:
                q = (out.pair_lo.to(torch.int64) << 32) | out.pair_hi.to(torch.int64)
                i = torch.searchsorted(pk, q).clamp_(max=P - 1)
                hit = (out.pair_lo >= 0) & (pk[i] == q)
                acc["pairacc"].index_add_(
                    0, torch.where(hit, i, P),
                    torch.ones_like(i, dtype=torch.int32))
            acc["cnts_u"] += out.cnts_u
            acc["cnts_d"] += out.cnts_d
            acc["nundet"] += out.nundet
            acc["nconf"] += out.nconf
            torch.maximum(acc["ovs"], out.overflow_slots, out=acc["ovs"])
        host = {k: v.cpu().numpy() for k, v in acc.items()}  # the pass's sync
        ovs = int(host["ovs"])
        if ovs:
            self.maxm *= 2
            if self.maxm > MAXM_LIMIT:
                raise RuntimeError(
                    f"sort-join slot overflow persists (slots={ovs})")
            return None
        return host

    def batch_size(self, reads: ReadSet) -> int:
        """The configured batch, shrunk to the read count rounded up to a
        power of two (at least 256)."""
        bs = self.cfg.batch_size
        if reads.num_reads < bs:
            bs = max(256, 1 << (max(reads.num_reads - 1, 1)).bit_length())
            bs = min(bs, self.cfg.batch_size)
        return bs

    def run(self, reads: ReadSet, sc_mode: bool = False,
            with_rcounts: bool = True, timings: Timings | None = None,
            verbose: bool = False) -> QueryCounts:
        """Classify every read.  ``with_rcounts=False`` skips the
        per-entry counts (Type-I output needs only ``cnts_u``); sc mode
        takes none, as the JAX session, and fills ``pair_counts``."""
        with_rcounts = with_rcounts and not sc_mode
        bs = self.batch_size(reads)
        if reads.num_reads:
            # trim the batch width to the longest read: every extra column
            # adds probe offsets to the hot loop
            lp_eff = min(reads.codes.shape[1], int(reads.lengths.max()))
            if lp_eff < reads.codes.shape[1]:
                reads = ReadSet(codes=reads.codes[:, :lp_eff],
                                lengths=reads.lengths,
                                total_len=reads.total_len, name=reads.name)
        with stage_timer("query", timings, verbose):
            while True:
                host = self._run_pass(reads, bs, with_rcounts, sc_mode)
                if host is not None:
                    break
        eu = self.num_entries_u
        rc = (host["rcount"][:-1].astype(np.int64) if with_rcounts
              else np.zeros(eu + self.num_entries_d, np.int64))
        pair_counts = {}
        if sc_mode:
            keys = self._pair_keys_host
            pa = host["pairacc"][:keys.shape[0]]
            for k in np.nonzero(pa)[0]:
                pair_counts[(int(keys[k] >> 32), int(keys[k] & 0xFFFFFFFF))] = int(pa[k])
        nr = reads.num_reads
        return QueryCounts(
            cnts_u=host["cnts_u"].astype(np.int64),
            cnts_d=host["cnts_d"].astype(np.int64),
            rcount_u=rc[:eu], rcount_d=rc[eu:eu + self.num_entries_d],
            nundet=int(host["nundet"]), nconf=int(host["nconf"]),
            pair_counts=pair_counts, num_reads=nr,
            mean_read_len=(reads.total_len // nr) if nr else 0,
        )
