"""Uniqueness stages of the device index build, on torch tensors.

Twins of ``cammiq_tpu/index/unique_jax.py``, op for op, so the outputs are
bit-identical.  Arrays are int32 on the build's device, in rank order
unless named ``*_text``; ``lcp`` is int32 [n+1] with lcp[0] = lcp[n] = 0.

  run_info     runs of equal GSA; the run bottom ``rb`` and top ``rt`` are
               the first-of-run scan (``kernels/first_of_run.py``) in index
               mode, forward and reverse
  compute_gsa  genome of each rank (``torch.searchsorted``, side right)
  unique_lcp0, doubly_lcp0
               the runs' segmented minima of lcp, forward and reverse
               (``ops/scans.py``: one launch each of
               ``kernels/segmented_min.py``'s scan, no flipped copies),
               and the elementwise epilogue
  min_unique   a scatter-min to text order
  occ_unique, occ_doubly
               the OCC walks (``kernels/occ_count.py``), scattered to
               text order
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.first_of_run import first_of_run_scan
from ..kernels.occ_count import occ_count_doubly, occ_count_unique
from ..ops.scans import segmented_cummin, segmented_cummin_rev
from .sparsify import MU_EMPTY


class Runs(NamedTuple):
    starts: torch.Tensor   # bool [n]: rank starts a run of equal GSA
    ends: torch.Tensor     # bool [n]: rank ends a run
    rb: torch.Tensor       # int32 [n]: first rank of the run
    rt: torch.Tensor       # int32 [n]: last rank of the run
    rid: torch.Tensor      # int32 [n]: run ordinal
    nruns: int


def run_info(gsa: torch.Tensor) -> Runs:
    n = gsa.shape[0]
    dev = gsa.device
    starts = torch.ones(n, dtype=torch.bool, device=dev)
    starts[1:] = gsa[1:] != gsa[:-1]
    ends = torch.ones(n, dtype=torch.bool, device=dev)
    ends[:-1] = starts[1:]
    # rb[i] = the last start at or before i, rt[i] = the first end at or
    # after i: the scan in index mode, forward and reverse
    (rb,) = first_of_run_scan(starts)
    (rt,) = first_of_run_scan(ends, reverse=True)
    rid = torch.cumsum(starts, 0, dtype=torch.int32) - 1
    return Runs(starts, ends, rb, rt, rid, int(rid[-1]) + 1)


def compute_gsa(sa: torch.Tensor, ref_pos: np.ndarray,
                ref_id: np.ndarray) -> torch.Tensor:
    """GSA[i] = ref_id[first file j with SA[i] < ref_pos[j]]."""
    dev = sa.device
    rp = torch.from_numpy(np.asarray(ref_pos, np.int64)).to(dev)
    rid = torch.from_numpy(np.asarray(ref_id, np.int64).astype(np.int32)).to(dev)
    j = torch.searchsorted(rp, sa.to(torch.int64), right=True)
    return rid[j]


def _direction_mins(lcp: torch.Tensor, runs: Runs):
    n = runs.starts.shape[0]
    A = segmented_cummin_rev(lcp[1:n + 1], runs.ends)
    B = segmented_cummin(lcp[:n], runs.starts)
    return A, B


def unique_lcp0(gsa: torch.Tensor, lcp: torch.Tensor, el: int) -> torch.Tensor:
    runs = run_info(gsa)
    A, B = _direction_mins(lcp, runs)
    first = runs.rid == 0
    last = runs.rid == runs.nruns - 1
    nruns = runs.nruns
    del runs
    out = torch.maximum(A, B).clamp_(min=el)
    out = torch.where(first, A.clamp_(min=el), out)
    del A, first
    out = torch.where(last, B, out)
    if nruns == 1:
        out.zero_()
    return out


def doubly_lcp0(sa: torch.Tensor, gsa: torch.Tensor, lcp: torch.Tensor,
                el: int, ulmax: int):
    """-> (lcp0 int32 [n] per rank, sentinel ulmax + 2; gsa2_text int32 [n],
    the second genome per text position).

    The same expressions as ``doubly_lcp0_jax``, ordered so that each
    full-size temporary is freed as soon as it is last read (at n = 6e8
    each one is 2.4 GB, or 4.8 GB as int64)."""
    runs = run_info(gsa)
    n = gsa.shape[0]
    sentinel = ulmax + 2
    A, B = _direction_mins(lcp, runs)
    first = runs.rid == 0
    last = runs.rid == runs.nruns - 1
    multi = runs.nruns > 1
    nxt = (runs.rt + 1).clamp_(max=n - 1).long()   # first rank of the next run
    prev = (runs.rb - 1).clamp_(min=0).long()      # last rank of the previous run
    del runs
    Aprime = torch.where(last, 0, A)

    # case 2 (A' > B): m2f = min(LCP[rb(next)], A[rb(next)])
    case2 = torch.minimum(lcp[nxt], A[nxt])
    del A
    case2 = torch.maximum(B, case2).clamp_(min=el)
    case2 = torch.where(case2 >= Aprime, sentinel, case2)
    # case 1 (A' < B): m2b = min(B[i], B[rt(previous run)])
    case1 = torch.minimum(B, B[prev])
    case1 = torch.maximum(Aprime, case1).clamp_(min=el)
    case1 = torch.where(case1 >= B, sentinel, case1)

    lt = Aprime < B
    out = torch.where(lt, case1, torch.where(Aprime > B, case2, sentinel))
    del B, case1, case2
    out = torch.where(first, Aprime, out)
    del Aprime
    if not multi:
        out.zero_()
    # g2: the previous run's genome in case 1, else the next run's
    g2_rank = torch.where(lt & ~first, gsa[prev], gsa[nxt])
    del prev, nxt, first
    write = (~last | lt) & multi
    del last, lt
    # sa is a permutation: every text position is written exactly once
    gsa2_text = torch.zeros(n, dtype=torch.int32, device=gsa.device)
    gsa2_text[sa.long()] = torch.where(write, g2_rank, 0).to(torch.int32)
    return out.to(torch.int32), gsa2_text


def min_unique(sa: torch.Tensor, lcp0: torch.Tensor, n: int,
               ulmax: int | None = None) -> torch.Tensor:
    """MU int32 [n + 1]: per text end position, the least LCP0 of the ranks
    whose shortest unique prefix ends there (MU_EMPTY where none)."""
    tgt = sa.to(torch.int64) + lcp0 + 1
    keep = tgt <= n
    if ulmax is not None:
        keep &= lcp0 < ulmax
    tgt = torch.where(keep, tgt, n)
    vals = torch.where(keep, lcp0, MU_EMPTY).to(torch.int32)
    mu = torch.full((n + 1,), MU_EMPTY, dtype=torch.int32, device=sa.device)
    mu.scatter_reduce_(0, tgt, vals, "amin")
    mu[n] = MU_EMPTY
    return mu


def occ_unique(sa: torch.Tensor, gsa: torch.Tensor, lcp: torch.Tensor,
               lcp0: torch.Tensor) -> torch.Tensor:
    """Own-genome occurrence count per text position, int32 [n]."""
    occ = torch.zeros_like(gsa)
    occ[sa.long()] = occ_count_unique(lcp, lcp0, gsa)
    return occ


def occ_doubly(sa: torch.Tensor, gsa: torch.Tensor, gsa2_text: torch.Tensor,
               lcp: torch.Tensor, lcp0: torch.Tensor, ulmax: int):
    """(own-genome, second-genome) occurrence counts per text position."""
    n = gsa.shape[0]
    sal = sa.long()
    g2_rank = gsa2_text[sal]
    # runs.rt[0] of the JAX version: the last rank of the first run
    other = gsa != gsa[0]
    end_excl = int(torch.argmax(other.to(torch.uint8))) - 1 if bool(other.any()) else n - 1
    del other
    occ_r, occ2_r = occ_count_doubly(lcp, lcp0, gsa, g2_rank, ulmax, end_excl)
    occ = torch.zeros_like(gsa)
    occ2 = torch.zeros_like(gsa)
    occ[sal] = occ_r
    occ2[sal] = occ2_r
    return occ, occ2
