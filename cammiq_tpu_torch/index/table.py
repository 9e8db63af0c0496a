"""Flat, vectorizable index table (replaces the reference's pointer tries):
a copy of ``cammiq_tpu/index/table.py``.

The reference stores selected substrings in a robin-hood hash map of 4-ary
tries (src/hashtrie.{hpp,cpp}).  Pointer-chasing is hostile to TPUs, so the
TPU-native layout is fully flat:

- every substring is packed 2-bit into KW uint32 words (base t at bits
  [2(t%16)] of word t//16), plus a length;
- entries are sorted by their h-base prefix; each distinct prefix is a
  "bucket" = a contiguous [start, count) range of entries;
- an open-addressing power-of-two hash table maps prefix -> bucket with a
  build-time-bounded probe distance (max_probes), so a query probe is a
  fixed small number of gathers;
- payloads (refID1, refID2, ucount1, ucount2, depth) live in parallel
  int32 arrays indexed by entry id; entry id doubles as the identity the
  reference's pleafNode pointer provides (rcount accumulators index by it).

Invariants enforced at build (reference aborts on violation,
src/hashtrie.cpp:146-149):
- no key is a proper prefix of another;
- exact duplicate keys must carry identical payloads (then deduped).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..ops.packing import SYMBOL_IDX, length_masks, rev2bit_u32
from ..utils.timing import spanned
from .sparsify import SelectedSubstrings

_HASH_C1 = np.uint32(0x85EBCA6B)
_HASH_C2 = np.uint32(0xC2B2AE35)


def _mix32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x = (x * _HASH_C1).astype(np.uint32)
        x ^= x >> np.uint32(13)
        x = (x * _HASH_C2).astype(np.uint32)
        x ^= x >> np.uint32(16)
    return x


def hash_prefix(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """32-bit hash of a (lo, hi) uint32 prefix-key pair."""
    with np.errstate(over="ignore"):
        return _mix32(np.asarray(lo, np.uint32) ^ _mix32(np.asarray(hi, np.uint32) + np.uint32(0x9E3779B9)))


@dataclasses.dataclass
class FlatIndex:
    """One flat table (unique or doubly)."""

    h: int                     # prefix / hash length in bases
    kw: int                    # key words per entry
    # entries, sorted by bucket
    key_words: np.ndarray      # uint32 [E, kw]
    length: np.ndarray        # int32 [E] total substring length (>= h)
    rid1: np.ndarray           # int32 [E]
    rid2: np.ndarray           # int32 [E] (0 in the unique table)
    ucount1: np.ndarray        # int32 [E]
    ucount2: np.ndarray        # int32 [E]
    # open-addressing prefix table
    table_lo: np.ndarray       # uint32 [T]
    table_hi: np.ndarray       # uint32 [T]
    table_start: np.ndarray    # int32 [T] bucket start entry (or -1 empty)
    table_count: np.ndarray    # int32 [T]
    max_probes: int            # bound on linear-probe displacement
    max_bucket: int            # max entries per bucket
    is_doubly: bool

    @property
    def num_entries(self) -> int:
        return int(self.length.shape[0])

    @property
    def table_size(self) -> int:
        return int(self.table_start.shape[0])

    def depth(self) -> np.ndarray:
        """The reference pleafNode 'depth' = full substring length
        (trie depth + hash_len, src/hashtrie.cpp:452,476)."""
        return self.length


def _prefix_lo_hi(words: np.ndarray, h: int) -> Tuple[np.ndarray, np.ndarray]:
    nb0 = min(h, 16)
    mask0 = np.uint32(0xFFFFFFFF) if nb0 >= 16 else np.uint32((1 << (2 * nb0)) - 1)
    lo = words[:, 0] & mask0
    if h > 16:
        nb1 = h - 16
        mask1 = np.uint32(0xFFFFFFFF) if nb1 >= 16 else np.uint32((1 << (2 * nb1)) - 1)
        hi = words[:, 1] & mask1
    else:
        hi = np.zeros_like(lo)
    return lo, hi


def extract_entry_words(corpus_seq: np.ndarray,
                        selected: SelectedSubstrings, kw: int) -> np.ndarray:
    """2-bit-pack the selected substrings into [S, kw] uint32 key words.
    Gathers chunked (the [S, kw*16] int64 intermediate is 512*S bytes —
    10 GB at a 20M-entry production index).  Standalone so sharded builds
    can extract against their LOCAL corpus slice (parallel/dist_build.py)
    before the driver assembles the entries."""
    S = selected.size
    starts = selected.start
    lens = selected.length
    offs = np.arange(kw * 16, dtype=np.int64)
    words = np.empty((S, kw), np.uint32)
    CHUNK = 1 << 20
    shifts = (2 * np.arange(16, dtype=np.uint32))
    for c0 in range(0, S, CHUNK):
        c1 = min(c0 + CHUNK, S)
        pos = starts[c0:c1, None] + offs[None, :]
        np.minimum(pos, corpus_seq.shape[0] - 1, out=pos)
        codes = SYMBOL_IDX[corpus_seq[pos]]        # int8
        valid = offs[None, :] < lens[c0:c1, None]
        if ((codes < 0) & valid).any():
            raise ValueError("selected substring contains non-ACGT characters")
        c32 = (np.where(valid, codes, 0).astype(np.uint32) & np.uint32(3))
        words[c0:c1] = np.bitwise_or.reduce(
            c32.reshape(-1, kw, 16) << shifts, axis=-1
        )
    return words


def _empty_flat_index(h: int, kw: int, is_doubly: bool) -> FlatIndex:
    t = 8
    return FlatIndex(
        h=h, kw=kw,
        key_words=np.zeros((0, kw), np.uint32),
        length=np.zeros(0, np.int32),
        rid1=np.zeros(0, np.int32), rid2=np.zeros(0, np.int32),
        ucount1=np.zeros(0, np.int32), ucount2=np.zeros(0, np.int32),
        table_lo=np.zeros(t, np.uint32), table_hi=np.zeros(t, np.uint32),
        table_start=np.full(t, -1, np.int32), table_count=np.zeros(t, np.int32),
        max_probes=1, max_bucket=0, is_doubly=is_doubly,
    )


def build_flat_index(
    corpus_seq: np.ndarray,
    selected: SelectedSubstrings,
    h: int,
    Lmax: int,
    is_doubly: bool,
    load_factor: float = 0.5,
) -> FlatIndex:
    """Pack selected substrings into a FlatIndex."""
    kw = max(2, (Lmax + 15) // 16)
    S = selected.size
    if S == 0:
        return _empty_flat_index(h, kw, is_doubly)
    words = extract_entry_words(corpus_seq, selected, kw)
    return build_flat_index_from_entries(
        words, selected.length, selected.rid, selected.occ,
        selected.rid2, selected.occ2, h, is_doubly, load_factor)


def build_flat_index_from_entries(
    words: np.ndarray, lens: np.ndarray, rid_a: np.ndarray,
    occ_a: np.ndarray, rid_b: np.ndarray, occ_b: np.ndarray,
    h: int, is_doubly: bool, load_factor: float = 0.5,
) -> FlatIndex:
    """Assemble a FlatIndex from already-extracted entries (possibly
    concatenated from several corpus shards): canonicalize, dedupe,
    bucket-sort, and build the open-addressing prefix table."""
    kw = words.shape[1]
    S = words.shape[0]
    if S == 0:
        return _empty_flat_index(h, kw, is_doubly)
    lens = np.asarray(lens, np.int64)

    # canonicalize doubly pair orientation (the reference accepts the
    # swapped payload as consistent, src/hashtrie.cpp:74-87): smaller rid
    # first, occ counts travel with their rid
    rid_a, occ_a = np.asarray(rid_a).copy(), np.asarray(occ_a).copy()
    rid_b, occ_b = np.asarray(rid_b).copy(), np.asarray(occ_b).copy()
    if is_doubly:
        swap = (rid_b != 0) & (rid_a > rid_b)
        rid_a2 = np.where(swap, rid_b, rid_a)
        occ_a2 = np.where(swap, occ_b, occ_a)
        rid_b = np.where(swap, rid_a, rid_b)
        occ_b = np.where(swap, occ_a, occ_b)
        rid_a, occ_a = rid_a2, occ_a2

    # dedupe exact duplicates; validate payload equality
    full = np.concatenate(
        [words, lens[:, None].astype(np.uint32)], axis=1
    )
    order = np.lexsort(tuple(full[:, c] for c in range(full.shape[1] - 1, -1, -1)))
    fs = full[order]
    first = np.ones(S, dtype=bool)
    first[1:] = (np.diff(fs.astype(np.int64), axis=0) != 0).any(axis=1)
    group = np.cumsum(first) - 1
    payload = np.stack(
        [rid_a[order], occ_a[order], rid_b[order], occ_b[order]], axis=1
    )
    # all rows in a dup-group must have equal payload (reference asserts)
    same_as_prev = ~first
    if same_as_prev.any():
        bad = (payload[same_as_prev] != payload[np.nonzero(same_as_prev)[0] - 1]).any()
        if bad:
            raise ValueError("duplicate key with mismatching payload (reference aborts)")
    keep = order[first]
    words = words[keep]
    lens = lens[keep]
    rid1 = rid_a[keep]
    rid2 = rid_b[keep]
    uc1 = occ_a[keep]
    uc2 = occ_b[keep]
    E = words.shape[0]

    # sort by prefix to form buckets
    plo, phi = _prefix_lo_hi(words, h)
    order = np.lexsort((lens, plo, phi))
    words, lens = words[order], lens[order]
    rid1, rid2, uc1, uc2 = rid1[order], rid2[order], uc1[order], uc2[order]
    plo, phi = plo[order], phi[order]
    newb = np.ones(E, dtype=bool)
    newb[1:] = (plo[1:] != plo[:-1]) | (phi[1:] != phi[:-1])
    bstart = np.nonzero(newb)[0]
    bcount = np.diff(np.concatenate([bstart, [E]]))
    nb = bstart.shape[0]
    max_bucket = int(bcount.max())

    # prefix-freeness within buckets (reference: abortInsert)
    _check_prefix_free(words, lens, bstart, bcount)

    # open-addressing table; slots assigned by the vectorized linear-probe
    # construction (no per-bucket Python loop - nb reaches millions at a
    # 1K-genome DB)
    t = 8
    while t < nb / load_factor:
        t *= 2
    while True:
        hv = hash_prefix(plo[bstart], phi[bstart]).astype(np.int64) & (t - 1)
        slots, max_disp = _assign_slots(hv, t)
        if slots is not None:
            break
        t *= 2
    table_lo = np.zeros(t, np.uint32)
    table_hi = np.zeros(t, np.uint32)
    table_start = np.full(t, -1, np.int32)
    table_count = np.zeros(t, np.int32)
    table_lo[slots] = plo[bstart]
    table_hi[slots] = phi[bstart]
    table_start[slots] = bstart
    table_count[slots] = bcount

    return FlatIndex(
        h=h, kw=kw,
        key_words=words.astype(np.uint32),
        length=lens.astype(np.int32),
        rid1=rid1.astype(np.int32), rid2=rid2.astype(np.int32),
        ucount1=uc1.astype(np.int32), ucount2=uc2.astype(np.int32),
        table_lo=table_lo, table_hi=table_hi,
        table_start=table_start, table_count=table_count,
        max_probes=max_disp + 1, max_bucket=max_bucket,
        is_doubly=is_doubly,
    )


def _assign_slots(hv: np.ndarray, t: int):
    """Vectorized linear-probe slot assignment: insert keys in hash order;
    slot_i = max(h_i, slot_{i-1}+1) over the hash-sorted sequence, i.e.
    slot = rank + cummax(h - rank).  Valid (identical to masked probing)
    as long as no slot exceeds t-1 and displacement stays <= 64; returns
    (None, None) to signal a table resize otherwise."""
    nb = hv.shape[0]
    if nb == 0:
        return np.zeros(0, np.int64), 0
    order = np.argsort(hv, kind="stable")
    hs = hv[order]
    r = np.arange(nb, dtype=np.int64)
    slots_sorted = r + np.maximum.accumulate(hs - r)
    disp = slots_sorted - hs
    if slots_sorted[-1] >= t or disp.max() > 64:
        return None, None
    slots = np.empty(nb, np.int64)
    slots[order] = slots_sorted
    return slots, int(disp.max())


def _check_prefix_free(words: np.ndarray, lens: np.ndarray,
                       bstart: np.ndarray, bcount: np.ndarray) -> None:
    """No key may be a proper prefix of another (reference abortInsert,
    src/hashtrie.cpp:146-149).

    Vectorized: in the SYMBOL-lexicographic order of zero-padded keys with
    length as the final tiebreak, any prefix pair implies a prefix pair of
    ADJACENT entries (every key sorting between a and an extension of a
    also extends a), so checking adjacent pairs is exhaustive.  Raw packed
    words are NOT symbol-lexicographic (base t sits at the LOW bits
    2*(t%16), so uint32 order compares the last base of a word first);
    sorting must use the bit-group-reversed words, where base 0 occupies
    the most-significant bits and padding stays below."""
    E = words.shape[0]
    if E < 2:
        return
    kw = words.shape[1]
    rw = rev2bit_u32(words)
    # np.lexsort: LAST key is primary -> (lens, rw[kw-1], ..., rw[0])
    order = np.lexsort((lens,) + tuple(rw[:, c] for c in range(kw - 1, -1, -1)))
    w = words[order]
    l = lens[order]
    masks = length_masks(l[:-1], kw)           # [E-1, kw] masks of the shorter
    shorter = l[:-1] < l[1:]
    eq = ((w[1:] & masks) == (w[:-1] & masks)).all(axis=1)
    if (shorter & eq).any():
        raise ValueError(
            "Illegal insertion, another key with the same prefix already exists."
        )


def save_flat_index(path: str, idx: FlatIndex) -> None:
    np.savez_compressed(
        path,
        h=idx.h, kw=idx.kw, is_doubly=int(idx.is_doubly),
        key_words=idx.key_words, length=idx.length,
        rid1=idx.rid1, rid2=idx.rid2, ucount1=idx.ucount1, ucount2=idx.ucount2,
        table_lo=idx.table_lo, table_hi=idx.table_hi,
        table_start=idx.table_start, table_count=idx.table_count,
        max_probes=idx.max_probes, max_bucket=idx.max_bucket,
    )


@spanned("session.open")
def load_flat_index_pair(path_u: str, path_d):
    """Load the unique+doubly tables concurrently (2 decompression
    threads; zlib releases the GIL on large buffers).  The reference
    likewise loads its two tries in parallel at query start
    (src/query.cpp:109-123)."""
    from concurrent.futures import ThreadPoolExecutor

    if not path_d:
        return load_flat_index(path_u), None
    with ThreadPoolExecutor(2) as ex:
        fu = ex.submit(load_flat_index, path_u)
        fd = ex.submit(load_flat_index, path_d)
        return fu.result(), fd.result()


def load_flat_index(path: str) -> FlatIndex:
    z = np.load(path)
    return FlatIndex(
        h=int(z["h"]), kw=int(z["kw"]),
        key_words=z["key_words"], length=z["length"],
        rid1=z["rid1"], rid2=z["rid2"],
        ucount1=z["ucount1"], ucount2=z["ucount2"],
        table_lo=z["table_lo"], table_hi=z["table_hi"],
        table_start=z["table_start"], table_count=z["table_count"],
        max_probes=int(z["max_probes"]), max_bucket=int(z["max_bucket"]),
        is_doubly=bool(int(z["is_doubly"])),
    )
