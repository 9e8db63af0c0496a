"""Read classification: the reference's case analysis on torch tensors,
and the gather engine's classifier.

Port of ``cammiq_tpu/query/classify.py``, bit-identical: the case analysis
(160-275) is ``kernels/case_count.py`` (``case_analysis`` and
``rcounts_from_case``, op-for-op copies, are its plain version;
``case_count`` runs both in one launch of ``csrc/case_count.cu`` on a
CUDA tensor), and for the gather engine ``revcomp_batch`` (65-75),
``collect_matches`` (78-137) and ``classify_batch`` (277-304).

The gather engine probes both strands against both FlatIndex tables
(``collect_matches``: one launch of ``kernels/gather_probe.py`` on a CUDA
tensor, its plain version on a CPU one) and classifies every batch with
one launch of ``case_count`` and no host sync.  It has no capacity to
overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.case_count import (  # noqa: F401  (JAX's names here)
    CaseResult, case_analysis, case_count, rcounts_from_case)
from ..kernels.gather_probe import BIG, gather_probe
from .probe import DeviceIndex, revcomp_batch  # noqa: F401  (JAX's name here)


class MatchSlots(NamedTuple):
    """Per-read match slots.  slot id = global entry id or BIG (empty)."""

    slots: torch.Tensor   # int32 [B, S] global entry ids, BIG = empty
    rid1: torch.Tensor    # int32 [B, S]
    rid2: torch.Tensor    # int32 [B, S]
    in_u: torch.Tensor    # bool [B, S]: slot belongs to the unique table


class BatchCounts(NamedTuple):
    """One batch's counts on the device.  The overflow counts are None
    where the engine cannot overflow (gather), and the case fields None on
    a grid rank that only probes."""

    cnts_u: torch.Tensor    # int32 [G]
    cnts_d: torch.Tensor    # int32 [G]
    nundet: torch.Tensor    # int32 []
    nconf: torch.Tensor     # int32 []
    overflow_slots: torch.Tensor   # int32 []
    overflow_hits: torch.Tensor    # int32 []
    pair_lo: torch.Tensor   # int32 [B] assigned pair (sc mode) or -1
    pair_hi: torch.Tensor   # int32 [B]


def collect_matches(didx_u: DeviceIndex, didx_d: DeviceIndex,
                    codes: torch.Tensor, lengths: torch.Tensor) -> MatchSlots:
    """Probe both tables on both strands.  Global entry ids: unique entries
    map to [0, Eu), doubly to [Eu, Eu + Ed), Eu and Ed the tables' device
    lengths (JAX's single-device layout).  S = 4 * max(Lp - h + 1, 1)
    columns: [unique fwd | unique rc | doubly fwd | doubly rc]."""
    return MatchSlots(*gather_probe(didx_u, didx_d, codes, lengths))


def classify_batch(didx_u: DeviceIndex, didx_d: DeviceIndex,
                   codes: torch.Tensor, lengths: torch.Tensor,
                   num_genome_slots: int, rcount: torch.Tensor | None = None,
                   sc_mode: bool = False,
                   counts: torch.Tensor | None = None) -> BatchCounts:
    """Single-device gather classification of one batch, with no host sync
    on a CUDA device.  ``rcount`` (int32, at least Eu + Ed elements, Eu and
    Ed the tables' device lengths) is the pass accumulator, added in place:
    its first Eu elements are JAX's ``rcount_u``, the next Ed its
    ``rcount_d``.  ``counts`` (int32 [2G + 2]: cnts_u, cnts_d, nundet,
    nconf), when given, is the counts' pass accumulator, added in place."""
    ms = collect_matches(didx_u, didx_d, codes, lengths)
    cc = case_count(ms, lengths, num_genome_slots, sc_mode=sc_mode,
                    rcount=rcount, counts=counts)
    return BatchCounts(cc.cnts_u, cc.cnts_d, cc.nundet, cc.nconf, None, None,
                       cc.pair_lo, cc.pair_hi)
