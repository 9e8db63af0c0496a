"""The per-read case analysis and rcount accumulation of a query batch:
plain PyTorch version + wrapper.

Replaces ``cammiq_tpu/query/classify.py:case_analysis`` (160-260) and
``rcounts_from_case`` (263-275), both XLA.  ``case_analysis`` and
``rcounts_from_case`` below are their op-for-op copies, bit-identical to
JAX; ``case_count_plain`` runs the two as one call and is the kernel's
plain version.  Per read, over its distinct matched entries: U =
#distinct unique genome ids, P = #distinct genome pairs, and

  P==0: U==0 -> undetermined; U==1 -> cnts_u[r*]++; U>1 -> conflict
  P>=1: U>1 -> conflict; U==1 -> cnts_u[r*]++, cnts_d[r*]++ if every pair
        holds r*, else conflict; U==0, P==1 -> cnts_d[a]++, cnts_d[b]++;
        U==0, P>=2 -> cnts_d[i*]++ if the pairs' intersection is {i*},
        else conflict

and rcount[e] += 1 for every distinct entry e of every assigned read.

Kernel: ``csrc/case_count.cu`` (see the source note): a group of 8 to 32
lanes a read and 256 / g reads a block on rows of up to 1024 slots, one
block a read on wider ones; one launch a batch, no host sync.  A CPU
tensor takes the plain version; a CUDA tensor the kernel, which raises if
it cannot build or launch.  ``case_count_geometry`` reports the launch.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import torch

from .build import I32, VP, CudaKernel, check_tensor, load, stream_ptr
from .gather_probe import BIG

# the launcher's 14 arguments travel packed as int64 in one buffer:
# ctypes converts one argument instead of 14, a few microseconds a call
KERNEL = CudaKernel("cammiq_case_count_packed", [ctypes.c_char_p])
_pack = struct.Struct("<14q").pack
GEOMETRY_FIELDS = ("group_path", "lanes", "reads_per_block", "blocks",
                   "threads", "registers", "resident_blocks_per_sm",
                   "slots_per_load", "loads_per_lane", "shared_bytes")


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


class CaseCounts(NamedTuple):
    """A batch's counts.  ``cnts_u``, ``cnts_d``, ``nundet`` and ``nconf``
    are views of one int32 [2G + 2] tensor, in that order."""

    cnts_u: torch.Tensor    # int32 [G]
    cnts_d: torch.Tensor    # int32 [G]
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


def case_analysis(ms, lengths: torch.Tensor, num_genome_slots: int,
                  sc_mode: bool = False) -> CaseResult:
    """``ms``: anything with int32 [B, S] ``slots``, ``rid1``, ``rid2``
    (a ``query.classify.MatchSlots``)."""
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


def rcounts_from_case(case: CaseResult, lo: int, size: int) -> torch.Tensor:
    """int32 [size]: rcount[e] = #assigned reads whose distinct match set
    holds global entry id lo + e."""
    rslots = torch.where(case.dslot & case.assigned[:, None], case.sslots, BIG)
    flat = rslots.reshape(-1).to(torch.int64)
    tgt = torch.where((flat >= lo) & (flat < lo + size), flat - lo, size)
    out = torch.zeros(size + 1, dtype=torch.int32, device=flat.device)
    return out.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))[:size]


def _views(counts: torch.Tensor, G: int, pair_lo, pair_hi) -> CaseCounts:
    return CaseCounts(counts[:G], counts[G:2 * G], counts[2 * G],
                      counts[2 * G + 1], pair_lo, pair_hi)


def case_count_plain(ms, lengths: torch.Tensor, num_genome_slots: int,
                     sc_mode: bool = False, rcount: torch.Tensor | None = None,
                     counts: torch.Tensor | None = None) -> CaseCounts:
    """``case_analysis``, its counts added to ``counts`` (int32 [2G + 2],
    zeros when None), and ``rcounts_from_case`` over ``[0,
    rcount.numel())`` added to ``rcount`` when given; on any device."""
    G = num_genome_slots
    case = case_analysis(ms, lengths, G, sc_mode=sc_mode)
    if counts is None:
        counts = torch.zeros(2 * G + 2, dtype=torch.int32, device=lengths.device)
    counts += torch.cat([case.cnts_u, case.cnts_d, case.nundet[None],
                         case.nconf[None]])
    if rcount is not None:
        rcount += rcounts_from_case(case, 0, rcount.numel())
    return _views(counts, G, case.pair_lo, case.pair_hi)


def case_count(ms, lengths: torch.Tensor, num_genome_slots: int,
               sc_mode: bool = False, rcount: torch.Tensor | None = None,
               counts: torch.Tensor | None = None) -> CaseCounts:
    """int32 [B, S] ``ms.slots``/``rid1``/``rid2``, int32 lengths [B] ->
    the batch's ``CaseCounts``, its counts added to ``counts`` (int32
    [2G + 2], zeros when None); ``rcount`` (int32 [E], when given) gets
    +1 at each distinct slot id in ``[0, E)`` of each assigned read, in
    place."""
    slots, rid1, rid2 = ms.slots, ms.rid1, ms.rid2
    if slots.device.type == "cpu":
        return case_count_plain(ms, lengths, num_genome_slots, sc_mode,
                                rcount, counts)
    dev = slots.device
    if dev.type != "cuda":
        raise ValueError(f"case_count: unsupported device {dev}")
    G = num_genome_slots
    for name, t in (("slots", slots), ("rid1", rid1), ("rid2", rid2)):
        check_tensor(t, name, torch.int32, dev, 2)
    check_tensor(lengths, "lengths", torch.int32, dev, 1)
    B, S = slots.shape
    if rid1.shape != (B, S) or rid2.shape != (B, S) or lengths.shape != (B,):
        raise ValueError(f"case_count: rid1 {tuple(rid1.shape)}, rid2 "
                         f"{tuple(rid2.shape)}, lengths {tuple(lengths.shape)} "
                         f"for slots {(B, S)}")
    rc_ptr = rc_size = 0
    if rcount is not None:
        check_tensor(rcount, "rcount", torch.int32, dev, 1)
        rc_ptr, rc_size = rcount.data_ptr(), rcount.shape[0]
    if counts is None:
        counts = torch.zeros(2 * G + 2, dtype=torch.int32, device=dev)
    check_tensor(counts, "counts", torch.int32, dev, 1)
    if counts.shape != (2 * G + 2,):
        raise ValueError(f"case_count: counts {tuple(counts.shape)} for G = {G}")
    pairs = torch.empty(2, B, dtype=torch.int32, device=dev)
    p = pairs.data_ptr()
    KERNEL(_pack(slots.data_ptr(), rid1.data_ptr(), rid2.data_ptr(),
                 lengths.data_ptr(), B, S, G, int(sc_mode), counts.data_ptr(), p,
                 p + 4 * B, rc_ptr, rc_size, stream_ptr(dev)))
    return _views(counts, G, pairs[0], pairs[1])


def case_count_geometry(slots: torch.Tensor) -> dict:
    """How ``case_count`` launches on int32 [B, S] CUDA ``slots``
    (``GEOMETRY_FIELDS``): the path (group or a block a read), lanes a
    read, reads and threads a block, blocks, the kernel's registers a
    thread and resident blocks an SM, slots a load, loads a lane, static
    and dynamic shared bytes a block."""
    check_tensor(slots, "slots", torch.int32, slots.device, 2)
    B, S = slots.shape
    out = (ctypes.c_int * len(GEOMETRY_FIELDS))()
    lib = load()
    fn = lib.cammiq_case_count_geometry
    fn.argtypes, fn.restype = [I32, I32, VP, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    with torch.cuda.device(slots.device):
        err = fn(B, S, slots.data_ptr(), out)
    if err:
        raise RuntimeError(f"cammiq_case_count_geometry: CUDA error {err}: "
                           f"{lib.cammiq_error_string(err).decode()}")
    return dict(zip(GEOMETRY_FIELDS, out))


def case_count_traffic(ms, lengths: torch.Tensor, num_genome_slots: int,
                       rcount: torch.Tensor | None = None) -> dict:
    """What one call must move and compute, for its bound, from this
    batch's data: the slot ids read once (4 bytes a slot); of ``rid1`` and
    ``rid2`` only the 32-byte sectors that hold a valid slot's (a result
    depends on a slot's rids only where ``slot < BIG``); the lengths;
    each output written once (the counts, 8 bytes a read of pairs, and the
    rcount elements this batch's assigned reads touch, read and written);
    and ~2 operations a slot plus ~10 a valid one (the flags and the four
    reductions).  Counts sectors of contiguous [B, S] rows."""
    B, S = ms.slots.shape
    G = num_genome_slots
    valid = (ms.slots < BIG).reshape(-1)
    nvalid = int(valid.sum())
    sectors = int(torch.unique(torch.nonzero(valid)[:, 0] // 8).numel())
    case = case_analysis(ms, lengths, G)
    rslots = case.sslots[case.dslot & case.assigned[:, None]].to(torch.int64)
    touched = (0 if rcount is None else int(torch.unique(
        rslots[(rslots >= 0) & (rslots < rcount.numel())]).numel()))
    nbytes = (4 * B * S + 2 * 32 * sectors + 4 * B + 4 * (2 * G + 2) + 8 * B
              + 8 * touched)
    return {"bytes": nbytes, "ops": 2 * B * S + 10 * nvalid, "valid": nvalid,
            "rid_sectors": sectors, "rcount_touched": touched}
