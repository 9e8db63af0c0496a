"""The least time the card could take for a layer's work, counted from the
work and not from the structures the port chose.

The arithmetic is that of ``chip_smoke.py``'s ``bound``: bytes over the
card's memory bandwidth, or operations over the matching peak, whichever is
larger.  The query layers are integer gathers and compares; NVIDIA's data
sheet gives no peak for them outside the tensor cores, so their bound is
bytes alone (a lower bound on the time, so a share of it cannot pass 100%
unless the time leaves out work).

Peaks: NVIDIA H100 SXM data sheet, 3.35 TB/s of HBM3.  A roofline share
is stated against it with the card's power limit beside it.

The work of a batch of ``B`` reads of ``L`` bases whose probe finds ``M``
distinct (read, entry) matches (the reference's count):

- probe (``probe_bloom`` + ``cuckoo_verify`` + ``match_assemble``, or
  ``gather_probe``): the codes once (``B * L`` bytes) and the lengths
  (4 bytes a read); each matched entry's record once (``RECORD`` bytes:
  its key of up to 64 bases, 16 bytes, its length, 4, and its two genome
  labels, 8); each match written once (8 bytes: read and entry);
- case analysis (``case_count``): each match read once (8 bytes) with its
  entry's two labels (8 bytes); the read's decision written (4 bytes a
  read); the genome counters written once (4 bytes each of ``2G + 2``);
  in quant mode each match of an assigned read adds one to its entry's
  rcount (4 bytes read, 4 written).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
RECORD = 16 + 4 + 8


def bound_s(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def probe_bytes(B: int, L: int, matches: int) -> int:
    return B * (L + 4) + matches * (RECORD + 8)


def case_count_bytes(B: int, matches: int, rcount_adds: int, G: int) -> int:
    return 16 * matches + 4 * B + 4 * (2 * G + 2) + 8 * rcount_adds
