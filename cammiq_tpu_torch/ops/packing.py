"""DNA symbol tables and 2-bit packing (numpy host side): a copy of
``cammiq_tpu/ops/packing.py``, the tables and bit tricks the port's host
code calls (corpus, reads, flat tables, merged index, bench generator).

Byte-level parity with the reference corpus layout:
- genome bases are stored as ASCII + 165 (mod 256) bytes
  (reference: src/build.hpp:60 base_offset, src/build.cpp:188-193);
- contig separators are 4 bytes of the 28-bit contig id in 7-bit chunks,
  values in [0, 127] (reference: src/build.cpp:218-239);
- the 2-bit code is A=0, C=1, G=2, T=3 (reference symbolIdx,
  src/query.cpp:1860-1873 / src/hashtrie.cpp:701-714).

Packing convention used by the flat index and the query probe: base t of a
window lives at bits [2t, 2t+1] of word t//16 (little-endian within each
uint32 word), so masking a window to length l is a per-word AND with
((1 << 2*min(max(l-16w, 0), 16)) - 1).
"""

from __future__ import annotations

import numpy as np

BASE_OFFSET = 165  # reference: src/build.hpp:60

# ASCII -> 2-bit code; -1 for anything that is not A/C/G/T (upper or lower).
# Mirrors the reference symbolIdx including the offset-165 aliases at
# indices 230..249 (src/query.cpp:1860-1873).
SYMBOL_IDX = np.full(256, -1, dtype=np.int8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    SYMBOL_IDX[ord(_c)] = _v
    SYMBOL_IDX[ord(_c.lower())] = _v
    SYMBOL_IDX[(ord(_c) + BASE_OFFSET) % 256] = _v

# ASCII -> reverse-complement ASCII (A<->T, C<->G); identity elsewhere is
# never used because reads are N-scrubbed first (reference rcIdx,
# src/query.cpp:1875-1881).
RC_IDX = np.arange(256, dtype=np.uint8)
for _a, _b in ((ord("A"), ord("T")), (ord("C"), ord("G")),
               (ord("a"), ord("T")), (ord("c"), ord("G")),
               (ord("g"), ord("C")), (ord("t"), ord("A"))):
    RC_IDX[_a] = _b
RC_IDX[ord("T")] = ord("A")
RC_IDX[ord("G")] = ord("C")

def rev2bit_u32(x: np.ndarray) -> np.ndarray:
    """Reverse the 16 2-bit groups within each uint32.

    With the base-t-at-low-bits packing convention, reversed words compare
    symbol-lexicographically (base 0 lands in the most-significant bits),
    which sorted-order prefix checks rely on."""
    C = np.uint32
    x = np.asarray(x, np.uint32)
    x = ((x & C(0x33333333)) << C(2)) | ((x >> C(2)) & C(0x33333333))
    x = ((x & C(0x0F0F0F0F)) << C(4)) | ((x >> C(4)) & C(0x0F0F0F0F))
    x = ((x & C(0x00FF00FF)) << C(8)) | ((x >> C(8)) & C(0x00FF00FF))
    return ((x << C(16)) | (x >> C(16))).astype(np.uint32)


def length_masks(lengths: np.ndarray, n_words: int) -> np.ndarray:
    """Per-word AND-masks selecting the first `lengths` bases.

    lengths: [...] int; returns uint32 [..., n_words]."""
    lengths = np.asarray(lengths)
    w = np.arange(n_words)
    nb = np.clip(lengths[..., None] - 16 * w, 0, 16).astype(np.uint64)
    # (1 << 2*nb) - 1, with nb=16 -> 0xFFFFFFFF
    masks = ((np.uint64(1) << (2 * nb)) - np.uint64(1)).astype(np.uint32)
    return masks
