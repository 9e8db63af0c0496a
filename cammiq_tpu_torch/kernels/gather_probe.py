"""The gather engine's per-offset probe: plain PyTorch version + wrapper.

Replaces ``cammiq_tpu/query/classify.py:collect_matches`` (78-137) around
``cammiq_tpu/query/probe.py:probe_strand`` (129-193), both XLA: for every
(read b, offset o < O = max(Lp - h + 1, 1)), on the forward strand and on
the read's reverse complement, against the unique and the doubly
``DeviceIndex``, the matched entry (``probe_strand``) as a slot of
``MatchSlots`` with S = 4 * O columns in JAX's order

    [unique fwd | unique rc | doubly fwd | doubly rc]

slot = the entry's global id or BIG, rid1/rid2 of the entry or 0, and
``in_u`` True for the unique table's hits.  Unique entries take ids [0,
Eu) and doubly entries [Eu, Eu + Ed), Eu and Ed the tables' device
lengths (Eu is 1 for an empty unique table: its dummy entry).

Kernel: ``csrc/gather_probe.cu`` (see the source note), one launch for the
four outputs, no host sync.  A CPU tensor takes the plain version; a CUDA
tensor the kernel, which raises if it cannot build or launch.
"""

from __future__ import annotations

import torch

from ..query.probe import DeviceIndex, pack_rolling16, probe_strand, revcomp_batch
from .build import I32, VP, CudaKernel, check_tensor, stream_ptr
from .probe_bloom import num_offsets

BIG = 2**31 - 1
# one table's arguments: erec, E, rw, kw, trec, table_bits, max_probes,
# max_bucket, base
_TABLE = [VP, I32, I32, I32, VP, I32, I32, I32, I32]
KERNEL = CudaKernel("cammiq_gather_probe",
                    [VP, VP, I32, I32, I32, *_TABLE, *_TABLE, VP, VP, VP, VP, VP])
# longest batch width the kernel takes: one read's codes and its two
# strands' packed words (9 bytes a base) must fit a block's shared memory
MAX_LP = 24_000


def gather_probe_plain(didx_u: DeviceIndex, didx_d: DeviceIndex,
                       codes: torch.Tensor, lengths: torch.Tensor):
    """(slots, rid1, rid2 int32 [B, 4O], in_u bool [B, 4O]), op for op
    ``collect_matches`` of the JAX package, on any device."""
    B, Lp = codes.shape
    O = num_offsets(Lp, didx_u.h)
    dev = codes.device
    offsets = torch.arange(O, device=dev)
    Eu, Ed = didx_u.length.shape[0], didx_d.length.shape[0]
    eids = []
    for strand in (codes, revcomp_batch(codes, lengths)):
        p16 = pack_rolling16(strand)
        for didx in (didx_u, didx_d):
            eids.append(probe_strand(didx, p16, lengths, offsets))
    m_u = torch.cat([eids[0], eids[2]], 1)
    m_d = torch.cat([eids[1], eids[3]], 1)
    hit_u, hit_d = m_u >= 0, m_d >= 0
    lu, ld = m_u.clamp(0, Eu - 1), m_d.clamp(0, Ed - 1)
    slots = torch.cat([torch.where(hit_u, m_u, BIG),
                       torch.where(hit_d, m_d + Eu, BIG)], 1)
    rid1 = torch.cat([torch.where(hit_u, didx_u.rid1[lu], 0),
                      torch.where(hit_d, didx_d.rid1[ld], 0)], 1)
    rid2 = torch.cat([torch.where(hit_u, didx_u.rid2[lu], 0),
                      torch.where(hit_d, didx_d.rid2[ld], 0)], 1)
    in_u = torch.cat([hit_u, torch.zeros_like(hit_d)], 1)
    return (slots.to(torch.int32), rid1.to(torch.int32), rid2.to(torch.int32),
            in_u)


def _table_args(d: DeviceIndex, base: int, dev) -> list:
    check_tensor(d.erec, "erec", torch.int32, dev, 2)
    check_tensor(d.trec, "trec", torch.int32, dev, 2)
    E, rw = d.erec.shape
    if d.trec.shape != (1 << d.table_bits, 4) or rw < d.kw + 3 or rw % 4:
        raise ValueError(f"gather_probe: table {tuple(d.trec.shape)} for "
                         f"{d.table_bits} bits, records {tuple(d.erec.shape)} "
                         f"for kw {d.kw}")
    if not (1 <= d.max_probes and 1 <= d.max_bucket and E >= 1):
        raise ValueError("gather_probe: max_probes, max_bucket and the entry "
                         "count must be at least 1")
    if base < 0 or base + E > 2**31 - 1:
        raise ValueError(f"gather_probe: base {base} + {E} entries overflow int32")
    return [d.erec.data_ptr(), E, rw, d.kw, d.trec.data_ptr(), d.table_bits,
            d.max_probes, d.max_bucket, base]


def gather_probe(didx_u: DeviceIndex, didx_d: DeviceIndex, codes: torch.Tensor,
                 lengths: torch.Tensor):
    """int8 codes [B, Lp], int32 lengths [B] -> (slots, rid1, rid2 int32
    [B, 4O], in_u bool [B, 4O]), N = B * 4O < 2^31."""
    if codes.device.type == "cpu":
        return gather_probe_plain(didx_u, didx_d, codes, lengths)
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"gather_probe: unsupported device {dev}")
    check_tensor(codes, "codes", torch.int8, dev, 2)
    check_tensor(lengths, "lengths", torch.int32, dev, 1)
    B, Lp = codes.shape
    h = didx_u.h
    if lengths.shape[0] != B:
        raise ValueError(f"lengths: {lengths.shape[0]} for {B} reads")
    if didx_d.h != h or not 1 <= h <= 32:
        raise ValueError(f"gather_probe: h {h} / {didx_d.h}")
    S = 4 * num_offsets(Lp, h)
    if B * S >= 2**31 or Lp > MAX_LP:
        raise ValueError(f"gather_probe: {B} x {Lp} codes exceed the kernel's "
                         f"int32 slots or its {MAX_LP}-base reads")
    targs = (_table_args(didx_u, 0, dev)
             + _table_args(didx_d, didx_u.length.shape[0], dev))
    slots = torch.empty(B, S, dtype=torch.int32, device=dev)
    rid1 = torch.empty(B, S, dtype=torch.int32, device=dev)
    rid2 = torch.empty(B, S, dtype=torch.int32, device=dev)
    in_u = torch.empty(B, S, dtype=torch.bool, device=dev)
    KERNEL(codes.data_ptr(), lengths.data_ptr(), B, Lp, h, *targs,
           slots.data_ptr(), rid1.data_ptr(), rid2.data_ptr(), in_u.data_ptr(),
           stream_ptr(dev))
    return slots, rid1, rid2, in_u
