"""Reference index-format compatibility: read/write CAMMiQ .bin1/.bin2 -
a copy of ``cammiq_tpu/index/refcompat.py``.

Format (reference src/hashtrie.cpp:595-699, src/binaryio.cpp):
- two files: the main stream `<name>` and the bit stream `<name>.aux`;
- AUX is a bit stream, MSB-first per byte: header = doubly flag (1 bit),
  the literal 64 (7 bits), hash length (8 bits); then one
  structure bit per trie node in pre-order (1 = node present, 0 = absent
  child slot), with each present node followed by its 4 children;
- INT holds big-endian scalars: a 64-bit bucket key (2-bit packed h-base
  prefix, first base in the high bits) before each bucket's trie, and at
  each leaf the payload: refID (32) + ucount (16) for the unique index,
  refID1/refID2 (32+32) + ucount1/ucount2 (16+16) for the doubly index;
- terminator: 72 one-bits in AUX, END64 = 2^64-1 plus END32 low 16 bits
  in INT.

This allows a user of the reference to load their existing indexes into
this engine (``QuerySession(index_u, index_d, G, cfg, device=...)`` takes
the tables ``reference_index_to_flat`` returns, with either query engine),
and exports our indexes for the reference binary.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .sparsify import SelectedSubstrings
from .table import FlatIndex, build_flat_index

END64 = (1 << 64) - 1


class _BitReader:
    def __init__(self, aux: bytes, main: bytes):
        self.aux = aux
        self.main = main
        self.bitpos = 0
        self.intpos = 0

    def read_bit(self) -> int:
        byte = self.aux[self.bitpos >> 3] if (self.bitpos >> 3) < len(self.aux) else 0xFF
        v = (byte >> (7 - (self.bitpos & 7))) & 1
        self.bitpos += 1
        return v

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def read_u16(self) -> int:
        v = int.from_bytes(self.main[self.intpos : self.intpos + 2], "big")
        self.intpos += 2
        return v

    def read_u32(self) -> int:
        v = int.from_bytes(self.main[self.intpos : self.intpos + 4], "big")
        self.intpos += 4
        return v

    def read_u64(self) -> int:
        v = int.from_bytes(self.main[self.intpos : self.intpos + 8], "big")
        self.intpos += 8
        return v


class _BitWriter:
    def __init__(self):
        self.aux = bytearray()
        self.main = bytearray()
        self.cur = 0
        self.nbits = 0

    def write_bit(self, b: int) -> None:
        self.cur = (self.cur << 1) | (b & 1)
        self.nbits += 1
        if self.nbits == 8:
            self.aux.append(self.cur)
            self.cur = 0
            self.nbits = 0

    def write_bits(self, n: int, v: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write_bit((v >> i) & 1)

    def write_u16(self, v: int) -> None:
        self.main += int(v & 0xFFFF).to_bytes(2, "big")

    def write_u32(self, v: int) -> None:
        self.main += int(v & 0xFFFFFFFF).to_bytes(4, "big")

    def write_u64(self, v: int) -> None:
        self.main += int(v & END64).to_bytes(8, "big")

    def finish(self) -> None:
        # flush64: 72 one-bits to AUX; END64 + END32-low16 to INT
        for _ in range(72):
            self.write_bit(1)
        self.write_u64(END64)
        self.write_u16(0xFFFF)
        # any partial byte was completed by the 72 ones


def read_reference_index(path: str) -> Tuple[SelectedSubstringsLike, int, bool]:
    """Decode a reference .bin1/.bin2 into substring arrays.

    Returns (entries, hash_len, is_doubly) where entries carries codes
    (list of np.int8 arrays), rid1, rid2, uc1, uc2.
    """
    with open(path, "rb") as f:
        main = f.read()
    with open(path + ".aux", "rb") as f:
        aux = f.read()
    r = _BitReader(aux, main)
    doubly = r.read_bit()
    marker = r.read_bits(7)
    if marker != 64:
        raise ValueError(f"bad index marker {marker} (expected 64)")
    hash_len = r.read_bits(8)

    codes_list: List[np.ndarray] = []
    rid1: List[int] = []
    rid2: List[int] = []
    uc1: List[int] = []
    uc2: List[int] = []

    def decode_trie(prefix_codes: List[int]) -> bool:
        """Returns True if a node was present."""
        if r.read_bit() == 0:
            return False
        children = []
        any_child = False
        for c in range(4):
            prefix_codes.append(c)
            present = decode_trie(prefix_codes)
            prefix_codes.pop()
            any_child |= present
        if not any_child:
            # leaf: payload from INT stream
            codes_list.append(np.asarray(prefix_codes, dtype=np.int8))
            if doubly:
                rid1.append(r.read_u32())
                rid2.append(r.read_u32())
                uc1.append(r.read_u16())
                uc2.append(r.read_u16())
            else:
                rid1.append(r.read_u32())
                rid2.append(0)
                uc1.append(r.read_u16())
                uc2.append(0)
        return True

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        while True:
            key = r.read_u64()
            if key == END64:
                break
            # unpack the h-base bucket key (first base in high bits)
            kcodes = [(key >> (2 * (hash_len - 1 - i))) & 3 for i in range(hash_len)]
            decode_trie(list(kcodes))
    finally:
        sys.setrecursionlimit(old_limit)

    return (
        dict(codes=codes_list, rid1=np.asarray(rid1, np.int64),
             rid2=np.asarray(rid2, np.int64), uc1=np.asarray(uc1, np.int64),
             uc2=np.asarray(uc2, np.int64)),
        hash_len,
        bool(doubly),
    )


SelectedSubstringsLike = dict


def reference_index_to_flat(path: str, Lmax: Optional[int] = None) -> FlatIndex:
    """Load a reference .bin1/.bin2 as a FlatIndex."""
    entries, hash_len, doubly = read_reference_index(path)
    codes_list = entries["codes"]
    E = len(codes_list)
    maxlen = max((len(c) for c in codes_list), default=hash_len)
    if Lmax is None:
        Lmax = maxlen
    # pack into a synthetic "corpus": concatenate codes as offset-ASCII
    from ..ops.packing import ALPHABET, BASE_OFFSET

    seq = np.zeros(sum(len(c) for c in codes_list) + 1, np.uint8)
    starts = np.zeros(E, np.int64)
    lens = np.zeros(E, np.int64)
    pos = 0
    for e, c in enumerate(codes_list):
        starts[e] = pos
        lens[e] = len(c)
        seq[pos : pos + len(c)] = (ALPHABET[c].astype(np.uint16) + BASE_OFFSET) & 0xFF
        pos += len(c)
    sel = SelectedSubstrings(
        start=starts, length=lens,
        rid=entries["rid1"], occ=entries["uc1"],
        rid2=entries["rid2"], occ2=entries["uc2"],
        ulm_count=np.zeros(0, np.int64),
    )
    return build_flat_index(seq, sel, hash_len, int(Lmax), doubly)


def write_reference_index(path: str, idx: FlatIndex) -> None:
    """Encode a FlatIndex into the reference .bin1/.bin2 (+ .aux) format."""
    w = _BitWriter()
    w.write_bit(1 if idx.is_doubly else 0)
    w.write_bits(7, 64)
    w.write_bits(8, idx.h)

    # decode entry key words back to per-base codes
    E = idx.num_entries
    def entry_codes(e: int) -> np.ndarray:
        l = int(idx.length[e])
        out = np.zeros(l, np.int8)
        for t in range(l):
            word = int(idx.key_words[e, t // 16])
            out[t] = (word >> (2 * (t % 16))) & 3
        return out

    # group by bucket (entries are bucket-sorted in FlatIndex)
    from .table import _prefix_lo_hi

    if E:
        all_codes = [entry_codes(e) for e in range(E)]
        buckets: dict = {}
        for e in range(E):
            key = 0
            for t in range(idx.h):
                key = (key << 2) | int(all_codes[e][t])
            buckets.setdefault(key, []).append(e)

        def emit_trie(entries: List[int], depth: int) -> None:
            w.write_bit(1)
            # leaf: an entry whose full length == h + depth
            leaf = [e for e in entries if int(idx.length[e]) == idx.h + depth]
            by_child: List[List[int]] = [[], [], [], []]
            for e in entries:
                if int(idx.length[e]) > idx.h + depth:
                    by_child[int(all_codes[e][idx.h + depth])].append(e)
            for c in range(4):
                if by_child[c]:
                    emit_trie(by_child[c], depth + 1)
                else:
                    w.write_bit(0)
            if leaf:
                if len(leaf) != 1 or any(by_child):
                    raise ValueError("prefix-free violation while encoding")
                e = leaf[0]
                if idx.is_doubly:
                    w.write_u32(int(idx.rid1[e]))
                    w.write_u32(int(idx.rid2[e]))
                    w.write_u16(int(idx.ucount1[e]))
                    w.write_u16(int(idx.ucount2[e]))
                else:
                    w.write_u32(int(idx.rid1[e]))
                    w.write_u16(int(idx.ucount1[e]))

        import sys

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(100000)
        try:
            for key in buckets:
                w.write_u64(key)
                emit_trie(buckets[key], 0)
        finally:
            sys.setrecursionlimit(old_limit)

    w.finish()
    with open(path, "wb") as f:
        f.write(bytes(w.main))
    with open(path + ".aux", "wb") as f:
        f.write(bytes(w.aux))
