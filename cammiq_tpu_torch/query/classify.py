"""Read classification: the reference's case analysis on torch tensors.

Port of ``cammiq_tpu/query/classify.py:case_analysis`` (160-260), op for op,
so its outputs are bit-identical.  Per read, over its distinct matched
entries: U = #distinct unique genome ids, P = #distinct genome pairs, and

  P==0: U==0 -> undetermined; U==1 -> cnts_u[r*]++; U>1 -> conflict
  P>=1: U>1 -> conflict; U==1 -> cnts_u[r*]++, cnts_d[r*]++ if every pair
        holds r*, else conflict; U==0, P==1 -> cnts_d[a]++, cnts_d[b]++;
        U==0, P>=2 -> cnts_d[i*]++ if the pairs' intersection is {i*},
        else conflict
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 2**31 - 1


class MatchSlots(NamedTuple):
    """Per-read match slots.  slot id = global entry id or BIG (empty)."""

    slots: torch.Tensor   # int32 [B, S] global entry ids, BIG = empty
    rid1: torch.Tensor    # int32 [B, S]
    rid2: torch.Tensor    # int32 [B, S]
    in_u: torch.Tensor    # bool [B, S]: slot belongs to the unique table


class CaseResult(NamedTuple):
    cnts_u: torch.Tensor    # int32 [G]
    cnts_d: torch.Tensor    # int32 [G]
    assigned: torch.Tensor  # bool [B]
    dslot: torch.Tensor     # bool [B, S] distinct-entry mask on sorted slots
    sslots: torch.Tensor    # int32 [B, S] sorted slot ids
    nundet: torch.Tensor    # int32 []
    nconf: torch.Tensor     # int32 []
    pair_lo: torch.Tensor   # int32 [B] assigned pair (sc mode) or -1
    pair_hi: torch.Tensor   # int32 [B]


def _first_true_value(mask, values, fill):
    idx = torch.argmax(mask.to(torch.uint8), dim=-1, keepdim=True)
    got = torch.gather(values, -1, idx)[..., 0]
    return torch.where(mask.any(-1), got, fill)


def _first_occurrence(valid, *cols):
    """valid[:, j] and (j == 0 or any col differs from column j - 1)."""
    diff = torch.zeros_like(valid[:, 1:])
    for c in cols:
        diff |= c[:, 1:] != c[:, :-1]
    return torch.cat([valid[:, :1], valid[:, 1:] & diff], dim=1)


def case_analysis(ms: MatchSlots, lengths: torch.Tensor, num_genome_slots: int,
                  sc_mode: bool = False) -> CaseResult:
    slots, order = torch.sort(ms.slots, dim=1)
    # equal slot ids carry identical payloads, so tie order is immaterial
    rid1 = torch.gather(ms.rid1, 1, order)
    rid2 = torch.gather(ms.rid2, 1, order)
    valid = slots < BIG
    dslot = _first_occurrence(valid, slots)

    is_single = dslot & (rid2 == 0)
    is_pair = dslot & (rid2 != 0)
    rid_sorted = torch.sort(torch.where(is_single, rid1, BIG), dim=1).values
    rv_valid = rid_sorted < BIG
    U = _first_occurrence(rv_valid, rid_sorted).sum(1, dtype=torch.int32)
    rstar = _first_true_value(rv_valid, rid_sorted, BIG)

    plo = torch.where(is_pair, torch.minimum(rid1, rid2), BIG).to(torch.int64)
    phi = torch.where(is_pair, torch.maximum(rid1, rid2), BIG).to(torch.int64)
    pkey = torch.sort((plo << 32) | phi, dim=1).values     # lex (lo, hi)
    plo_s = (pkey >> 32).to(torch.int32)
    phi_s = (pkey & 0xFFFFFFFF).to(torch.int32)
    pv_valid = plo_s < BIG
    P = _first_occurrence(pv_valid, plo_s, phi_s).sum(1, dtype=torch.int32)
    a1 = _first_true_value(pv_valid, plo_s, BIG)
    b1 = _first_true_value(pv_valid, phi_s, BIG)

    def all_pairs_contain(x):
        x = x[:, None]
        return ((~is_pair) | (rid1 == x) | (rid2 == x)).all(1)

    pairs_have_rstar = all_pairs_contain(rstar)
    in_all_a = all_pairs_contain(a1)
    in_all_b = all_pairs_contain(b1)

    undet = (P == 0) & (U == 0)
    case_u_only = (P == 0) & (U == 1)
    case_ud = (P >= 1) & (U == 1) & pairs_have_rstar
    case_pair = (P == 1) & (U == 0)
    isect_size = torch.where(P >= 2, in_all_a.to(torch.int32)
                             + in_all_b.to(torch.int32), 0)
    case_isect = (P >= 2) & (U == 0) & (isect_size == 1)
    istar = torch.where(in_all_a, a1, b1)
    assigned = case_u_only | case_ud | case_pair | case_isect
    conf = (~undet) & ~assigned

    G = num_genome_slots

    def scat(idx, flag):
        tgt = torch.where(flag, idx, G).to(torch.int64)
        out = torch.zeros(G + 1, dtype=torch.int32, device=slots.device)
        return out.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))[:G]

    cnts_u = scat(rstar, case_u_only | case_ud)
    cnts_d = (scat(rstar, case_ud) + scat(a1, case_pair) + scat(b1, case_pair)
              + scat(istar, case_isect))

    real = lengths > 0
    nundet = (undet & real).sum(dtype=torch.int32)
    nconf = (conf & real).sum(dtype=torch.int32)
    if sc_mode:
        pair_lo = torch.where(case_pair & real, a1, -1).to(torch.int32)
        pair_hi = torch.where(case_pair & real, b1, -1).to(torch.int32)
    else:
        pair_lo = torch.full_like(lengths, -1, dtype=torch.int32)
        pair_hi = torch.full_like(lengths, -1, dtype=torch.int32)
    return CaseResult(cnts_u=cnts_u, cnts_d=cnts_d, assigned=assigned,
                      dslot=dslot, sslots=slots, nundet=nundet, nconf=nconf,
                      pair_lo=pair_lo, pair_hi=pair_hi)
