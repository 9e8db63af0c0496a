"""The merged query index, built on the host: a copy of the numpy builders
of ``cammiq_tpu/query/sortjoin.py``.

``build_merged_index`` merges the unique and doubly tables into one
bucket list keyed by a hash of the h-base prefix, adds a reverse-complement
twin of every entry (so the query probes the forward strand only) and
chain-colors the entries (within one color, keys are distinct and
prefix-free).  ``_build_bloom``/``_fold_bloom`` make the blocked bloom
filter, ``_build_cuckoo`` the span table, and ``_fused_records`` the
``erec``/``brec``/``prec`` records the device reads.  The code and its
output are those of the JAX package (numpy branches only); see that
module's docstring for why the forward-strand probe is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..index.table import FlatIndex, _prefix_lo_hi
from ..ops.packing import length_masks, rev2bit_u32


@dataclasses.dataclass
class MergedIndex:
    """Both tables merged + RC-augmented into one bucket list (host numpy)."""

    h: int
    kw: int
    eu: int                   # unique-table entry count (global id base)
    ed: int
    max_bucket: int
    n_colors: int             # prefix-chain colors (found-slots per probe)
    # merged entries, bucket-sorted
    key_words: np.ndarray     # uint32 [E, kw]
    length: np.ndarray        # int32 [E]
    rid1: np.ndarray          # int32 [E]
    rid2: np.ndarray          # int32 [E]
    gid: np.ndarray           # int32 [E] global id (u: [0,Eu), d: [Eu,Eu+Ed))
    color: np.ndarray         # int32 [E] chain color (< n_colors)
    # bucket rows: one per distinct (hlo, hhi) prefix hash; rows sharing
    # an hlo (prefix collisions) reference the same full entry span
    pref_lo: np.ndarray       # uint32 [NB] primary 32-bit prefix hash
    pref_hi: np.ndarray       # uint32 [NB] secondary 9-bit prefix hash
    bucket_start: np.ndarray  # int32 [NB] entry span start (per hlo)
    bucket_count: np.ndarray  # int32 [NB] entry span length
    # hash-space directory for the large-NB probe path: dir_start[t] =
    # first bucket row whose top dir_bits of pref_lo equal t
    dir_start: np.ndarray = None   # int32 [2^dir_bits + 1]
    dir_bits: int = 0
    dir_span_steps: int = 0        # binary-search rounds within a cell


# directory cells (4 MB of int32 at the cap); ~NB/2^20 rows per cell.
# Measured (r4, stage_cuts at production NB): raising the cap to 24 bits
# (64 MB table, 7->5 search rounds) made the search stage 3.5x SLOWER —
# per-element gather cost into the larger operand dwarfs the two saved
# rounds on this chip.  Keep the directory small.
DIR_BITS = 20

# blocked bloom filter cap: 2^26 uint32 words (256 MB) keeps the load at
# ~1 key/word up to NB = 64M (the 4K-genome config measures 61M bucket
# rows; capping at 2^24 there meant 3.6 keys/word, 3.5% false positives,
# and a 4x capacity widening that halved throughput)
BLOOM_LOG_WORDS = 26


def _build_bloom(pref_lo: np.ndarray, log_words: int | None = None):
    """Blocked bloom filter over the bucket hashes: one uint32 word per
    cell (top `log_words` bits of the key), 3 bit positions from the low
    key bits.  The hot loop tests membership with ONE gather per probe —
    ~99.9% of probes are non-matches at production scale, so the
    dir_span_steps binary-search rounds then run on only the compacted
    survivors instead of every (read, offset) candidate.

    pref_lo must be sorted ascending (bucket rows are), so equal cells
    are contiguous and the table builds with one bitwise_or.reduceat.
    Returns (table, log_words); the table sizes to ~1 word per key
    (capped at 2^BLOOM_LOG_WORDS = 64 MB)."""
    keys = np.ascontiguousarray(pref_lo, np.uint32)
    if log_words is None:
        log_words = min(max(int(max(keys.shape[0], 1)).bit_length(), 12),
                        BLOOM_LOG_WORDS)
    table = np.zeros(1 << log_words, np.uint32)
    if keys.shape[0]:
        w = (keys >> np.uint32(32 - log_words)).astype(np.int64)
        bits = _bloom_bits(keys)
        starts = np.nonzero(np.concatenate([[True], w[1:] != w[:-1]]))[0]
        table[w[starts]] = np.bitwise_or.reduceat(bits, starts)
    return table, log_words


def _bloom_bits(key):
    """3-bit mask for a key: positions from a MULTIPLICATIVE remix of the
    full 32-bit key, taken from the product's upper half — the word index
    is the key's top bits, so positions derived from raw low-bit fields
    would be partially determined by the word and collapse the filter's
    discrimination within a word (measured 2% FP vs the intended ~0.06%).
    """
    with np.errstate(over="ignore"):
        z = key * np.uint32(0x9E3779B1)
    return (
        (np.uint32(1) << ((z >> np.uint32(16)) & np.uint32(31)))
        | (np.uint32(1) << ((z >> np.uint32(21)) & np.uint32(31)))
        | (np.uint32(1) << ((z >> np.uint32(26)) & np.uint32(31)))
    )


# device-side bloom cap when the exact cuckoo stage follows: a 64 MB
# filter gathers ~1.7x faster than 128-512 MB operands on this chip
# (benchmarks/gather_scaling.py), and its higher FP rate at 60M+ keys
# only costs recompaction slots, not wrong results
BLOOM_DEVICE_LOG = 24


def _fold_bloom(table: np.ndarray, to_log: int):
    """Shrink a blocked bloom to 2^to_log words by OR-folding: the word
    index is the key's TOP log bits, so halving merges words (2i, 2i+1);
    bit positions are log-independent (_bloom_bits).  No false negatives
    are introduced — only the FP rate rises with the per-word load."""
    lw = int(table.shape[0]).bit_length() - 1
    while lw > to_log:
        table = np.bitwise_or(table[0::2], table[1::2])
        lw -= 1
    return table, lw


def _build_directory(pref_lo: np.ndarray, db: int | None = None):
    """(dir_start, dir_bits, span_steps) over the sorted bucket hashes."""
    nb = pref_lo.shape[0]
    if db is None:
        db = max(8, min(DIR_BITS, max(int(nb).bit_length() - 5, 8)))
    tops = (np.arange((1 << db) + 1, dtype=np.uint64) << (32 - db)).astype(np.uint64)
    tops = np.minimum(tops, np.uint64(0xFFFFFFFF) + np.uint64(1))
    dir_start = np.searchsorted(
        pref_lo.astype(np.uint64), tops, side="left"
    ).astype(np.int32)
    max_span = int(np.diff(dir_start).max()) if nb else 1
    steps = max(int(max_span).bit_length() + 1, 1)
    return dir_start, db, steps


# ---- cuckoo span table: the large-index search stage without dependent
# gathers.  The bloom path's remaining dependent chain was dir_span_steps
# (7-8) binary-search rounds gathering pref_lo[mid] from an NB-sized
# operand; measured on this chip (benchmarks/gather_scaling.py) that
# chain costs ~2.7 ms at K=19.2K while TWO independent [12]-word row
# gathers cost ~0.5 ms even into multi-GB operands.  So the artifact
# precomputes a 2-choice, 4-slot-per-bucket hash table mapping each
# DISTINCT 32-bit bucket hash to its entry span: row layout
# [k0..k3, s0..s3, c0..c3] (keys, span starts, span counts), empty slots
# have count 0 (a real span never does).  Lookup = 2 independent row
# gathers + vector compares; exactness is by full 32-bit key equality,
# identical to the binary search's pref_lo[found] == ck test, and the
# bucket scan verifies entry content either way.
CUCKOO_SLOTS = 4
# target load keys/(slots*rows) <= ~0.6: greedy 2-choice placement (no
# eviction chains) converges in a few rounds there; on failure the build
# retries one size up
_CUCKOO_LOAD = 2.4  # keys per ROW target (= 0.6 * CUCKOO_SLOTS)


def _cuckoo_pos(key, which: int, tlog: int):
    C = np.uint32
    with np.errstate(over="ignore"):
        if which == 0:
            z = key * C(0x9E3779B1)
        else:
            z = (key ^ C(0x85EBCA6B)) * C(0xC2B2AE35)
            z = z ^ (z >> C(15))
        p = z >> C(32 - tlog)
    return p.astype(np.int64)


def _cuckoo_try_place(keys, starts, counts, tlog: int, rng,
                      max_rounds: int = 64):
    """Parallel cuckoo placement with priority aging: every round ALL
    keys compete for their current-choice bucket's CUCKOO_SLOTS slots,
    older (more-displaced) keys winning ties — so a stuck key eventually
    EVICTS a settled one, which re-places via its alternate bucket (the
    vectorized equivalent of cuckoo hashing's displacement chains; pure
    greedy without eviction measurably jams at load ~0.45: ~11% of
    buckets are already full after the first round).  Returns the table
    or None if max_rounds pass without a full placement."""
    S = CUCKOO_SLOTS
    T = 1 << tlog
    nd = keys.shape[0]
    if nd == 0:
        return np.zeros((T, 3 * S), np.uint32)
    if nd > S * T:
        return None
    h = np.stack([_cuckoo_pos(keys, 0, tlog), _cuckoo_pos(keys, 1, tlog)])
    choice = np.zeros(nd, np.uint8)
    age = np.zeros(nd, np.int64)
    # sticky per-key tiebreak: settled winners stay settled unless an
    # older (more-displaced) key arrives, so later rounds touch only the
    # contended buckets — round 1 is the only full-population sort
    pri = rng.integers(0, 1 << 62, nd)
    occ = np.full((T, S), -1, np.int64)
    pending = np.arange(nd)
    for _ in range(max_rounds):
        if pending.size == 0:
            bi, si = np.nonzero(occ >= 0)
            ki = occ[bi, si]
            tab = np.zeros((T, 3 * S), np.uint32)
            tab[bi, si] = keys[ki]
            tab[bi, S + si] = np.asarray(starts, np.uint32)[ki]
            tab[bi, 2 * S + si] = np.asarray(counts, np.uint32)[ki]
            return tab
        pb = h[choice[pending], pending]
        aff = np.unique(pb)                     # contended buckets
        old = occ[aff].ravel()
        old = old[old >= 0]
        occ[aff] = -1
        cont = np.concatenate([old, pending])
        cb = np.concatenate([h[choice[old], old], pb])
        order = np.lexsort((pri[cont], -age[cont], cb))
        cs = cb[order]
        n = cs.shape[0]
        run_start = np.empty(n, bool)
        run_start[0] = True
        np.not_equal(cs[1:], cs[:-1], out=run_start[1:])
        first_pos = np.nonzero(run_start)[0]
        rank = np.arange(n) - first_pos[np.cumsum(run_start) - 1]
        win = rank < S
        winners = cont[order[win]]
        occ[cs[win], rank[win]] = winners
        losers = cont[order[~win]]
        choice[losers] ^= 1
        age[losers] += 1
        pending = losers
    return None


def _build_cuckoo(pref_lo, bucket_start, bucket_count,
                  tlog: int | None = None):
    """(table [T, 3*CUCKOO_SLOTS] uint32, tlog) over the DISTINCT primary
    bucket hashes; each key's span is its hlo run's full entry span (the
    first bucket row of the run — identical to lower_bound semantics).

    tlog=None sizes to keys/rows <= _CUCKOO_LOAD and retries one size up
    on placement failure.  A fixed tlog (the dist path: table shape is
    baked into a multi-process jitted program, so every process must
    agree statically) raises on failure instead — callers there size for
    load <= 0.4, where greedy 2-choice placement failing is a
    cryptographic-grade anomaly."""
    pref_lo = np.ascontiguousarray(pref_lo, np.uint32)
    nb = pref_lo.shape[0]
    first = np.ones(nb, bool)
    first[1:] = pref_lo[1:] != pref_lo[:-1]
    keys = pref_lo[first]
    starts = np.ascontiguousarray(bucket_start)[first]
    counts = np.ascontiguousarray(bucket_count)[first]
    nd = keys.shape[0]
    rng = np.random.default_rng(0xC0C0)
    if tlog is not None:
        tab = _cuckoo_try_place(keys, starts, counts, tlog, rng)
        if tab is None:
            raise RuntimeError(
                f"cuckoo span table: fixed-size placement failed at 2^{tlog}"
                f" rows for {nd} keys")
        return tab, tlog
    tl = max(int(np.ceil(np.log2(max(nd, 2) / _CUCKOO_LOAD))), 10)
    while tl <= 30:
        tab = _cuckoo_try_place(keys, starts, counts, tl, rng)
        if tab is not None:
            return tab, tl
        tl += 1
    raise RuntimeError("cuckoo span table: placement failed up to 2^30 rows")


_HHI_BITS = 9  # secondary-hash width stored per bucket row


def _hash_prefix(lo, hi):
    """Mix a (lo, hi) 2x32-bit packed h-prefix into a 32-bit primary hash
    and a 9-bit secondary hash (murmur3-style finalizers; identical uint32
    wraparound arithmetic under numpy and jax.numpy).

    The sort-join joins probes to buckets on (hlo, hhi) hash equality
    instead of the exact 52-bit prefix: the bucket scan fully verifies
    every candidate entry against the read, so a hash collision can only
    add a rejected candidate, never a wrong match.  Missed matches are
    impossible because bucket spans are keyed by hlo alone (equal prefix
    => equal hashes => joins the bucket's run)."""
    C = np.uint32
    lo = lo.astype(np.uint32)
    hi = hi.astype(np.uint32)
    x = lo ^ (hi * C(0x9E3779B1))
    x = (x ^ (x >> C(16))) * C(0x85EBCA6B)
    x = (x ^ (x >> C(13))) * C(0xC2B2AE35)
    x = x ^ (x >> C(16))
    y = hi ^ (lo * C(0x27D4EB2F))
    y = (y ^ (y >> C(15))) * C(0x165667B1)
    y = y ^ (y >> C(13))
    return x, y & C((1 << _HHI_BITS) - 1)


def _revcomp_packed(key_words: np.ndarray, length: np.ndarray, kw: int) -> np.ndarray:
    """Reverse-complement 2-bit-packed keys: rc[t] = 3 - key[len-1-t].

    Pure packed-word bit-twiddling (complement = XOR, base reversal =
    2-bit-group reversal + reversed word order, then a per-entry right
    shift by the padding width) - the unpack-to-codes route costs
    ~24 s per million entries at session build, this one is ~100x faster.
    """
    E = key_words.shape[0]
    length = np.asarray(length, np.int64)
    with np.errstate(over="ignore"):
        # full-width reverse complement: complement codes, reverse 2-bit
        # groups per word, reverse word order
        wrev = rev2bit_u32(key_words[:, ::-1] ^ np.uint32(0xFFFFFFFF))
        # shift right by the pad bases so base 0 of the RC lands at bit 0
        sb = kw * 16 - length                      # pad width in bases
        ws = (sb // 16).astype(np.int64)           # whole-word shift
        bs = (2 * (sb % 16)).astype(np.uint32)     # in-word bit shift
        ext = np.concatenate([wrev, np.zeros((E, 1), np.uint32)], axis=1)
        w_idx = np.arange(kw, dtype=np.int64)[None, :] + ws[:, None]
        w_idx = np.minimum(w_idx, kw)
        lo = np.take_along_axis(ext, w_idx, axis=1)
        hi = np.take_along_axis(ext, np.minimum(w_idx + 1, kw), axis=1)
        bs_c = bs[:, None]
        out = np.where(
            bs_c == 0, lo,
            (lo >> bs_c) | (hi << ((np.uint32(32) - bs_c) & np.uint32(31))),
        ).astype(np.uint32)
        out &= length_masks(length, kw)
    return out


def _adjacent_lcp(words_sorted: np.ndarray, lens_sorted: np.ndarray,
                  kw: int) -> np.ndarray:
    """alcp[i] = common-prefix length (in bases) of symbol-lex-sorted
    keys i-1 and i; alcp[0] = -1 sentinel.  Pure packed-word bit math:
    the first differing base is ctz(xor)/2 of the first differing word."""
    E = words_sorted.shape[0]
    alcp = np.full(E, -1, np.int64)
    if E < 2:
        return alcp
    first_diff = np.full(E - 1, kw * 16, np.int64)
    found = np.zeros(E - 1, bool)
    with np.errstate(over="ignore"):
        for w in range(kw):
            x = words_sorted[1:, w] ^ words_sorted[:-1, w]
            nz = (~found) & (x != 0)
            if nz.any():
                xv = x[nz]
                low = (xv & (~xv + np.uint32(1))).astype(np.float64)
                bit = np.frexp(low)[1] - 1        # ctz via exponent
                first_diff[nz] = 16 * w + (bit >> 1)
                found |= x != 0
            if found.all():
                break
    alcp[1:] = np.minimum(
        first_diff, np.minimum(lens_sorted[1:], lens_sorted[:-1])
    )
    return alcp


def _chain_colors_sorted(lens_sorted: np.ndarray,
                         alcp: np.ndarray) -> np.ndarray:
    """Chain colors over keys ALREADY in symbol-lex order (length as the
    tiebreak): color[i] = #{j < i : len_j <= min(alcp[j+1..i])}, i.e. the
    number of earlier keys that are prefixes of key i — proper prefixes
    plus earlier exact duplicates, which IS (prefix depth + duplicate
    rank).  In this order the extensions of key j form one contiguous
    interval (j, end_j], where end_j is the last position before alcp
    drops below len_j; colors are interval-open counts, computed with one
    suffix-min and one bincount per DISTINCT length (O(D*E), exact)."""
    E = lens_sorted.shape[0]
    if E == 0:
        return np.zeros(0, np.int32)
    idx = np.arange(E, dtype=np.int64)
    starts_all = []
    ends_all = []
    for t in np.unique(lens_sorted):
        # nxt[p] = first position >= p with alcp < t (suffix-min trick)
        cand = np.where(alcp < t, idx, E)
        nxt = np.minimum.accumulate(cand[::-1])[::-1]
        js = np.nonzero(lens_sorted == t)[0]
        starts = js + 1
        inb = starts < E
        ends = np.full(js.shape[0], E, np.int64)
        ends[inb] = nxt[starts[inb]]
        ok = starts < ends
        starts_all.append(starts[ok])
        ends_all.append(ends[ok])
    delta = (
        np.bincount(np.concatenate(starts_all), minlength=E + 1)[:E]
        - np.bincount(np.concatenate(ends_all), minlength=E + 1)[:E]
    )
    return np.cumsum(delta).astype(np.int32)


def _symlex_order(key_words: np.ndarray, length: np.ndarray, kw: int,
                  *extra_keys: np.ndarray) -> np.ndarray:
    """Stable symbol-lexicographic sort order (zero padding = base A) with
    (length, *extra_keys) as tiebreaks."""
    rw = rev2bit_u32(key_words)
    keys = tuple(reversed(extra_keys)) + (length,) + tuple(
        rw[:, c] for c in range(kw - 1, -1, -1)
    )
    return np.lexsort(keys)


def _chain_colors(key_words: np.ndarray, length: np.ndarray, kw: int) -> np.ndarray:
    """Color keys so that within one color class keys are DISTINCT and
    PREFIX-FREE (then at most one entry per color can match a given read
    offset).  color = (#keys that are proper prefixes of this key, with
    multiplicity) + (rank among exact duplicates).  If k1 is a proper
    prefix of k2, every prefix of k1 (and k1 itself, all its copies) is a
    prefix of k2, so color(k2) > color(any k1 copy); exact duplicates get
    distinct ranks.  One symbol-lex sort + exact adjacent-LCP intervals
    (no hashing; see _chain_colors_sorted)."""
    order = _symlex_order(key_words, length, kw)
    ws = key_words[order]
    ls = np.asarray(length, np.int64)[order]
    cs = _chain_colors_sorted(ls, _adjacent_lcp(ws, ls, kw))
    color = np.empty(ws.shape[0], np.int32)
    color[order] = cs
    return color


def build_merged_index(index_u: FlatIndex, index_d: Optional[FlatIndex]) -> MergedIndex:
    h, kw = index_u.h, index_u.kw
    eu = index_u.num_entries
    if index_d is not None and index_d.num_entries:
        if index_d.h != h:
            raise ValueError("unique/doubly hash lengths must match")
        kwd = index_d.kw
        kw = max(kw, kwd)

        def pad(wds, k):
            if wds.shape[1] == k:
                return wds
            return np.concatenate(
                [wds, np.zeros((wds.shape[0], k - wds.shape[1]), np.uint32)], axis=1
            )

        key_words = np.concatenate([pad(index_u.key_words, kw), pad(index_d.key_words, kw)])
        length = np.concatenate([index_u.length, index_d.length])
        rid1 = np.concatenate([index_u.rid1, index_d.rid1])
        rid2 = np.concatenate([index_u.rid2, index_d.rid2])
        ed = index_d.num_entries
    else:
        key_words = index_u.key_words
        length = index_u.length
        rid1, rid2 = index_u.rid1, index_u.rid2
        ed = 0
    gid = np.arange(eu + ed, dtype=np.int32)

    if length.shape[0] == 0:
        ds, db, steps = _build_directory(np.zeros(1, np.uint32))
        return MergedIndex(
            h=h, kw=kw, eu=eu, ed=ed, max_bucket=1, n_colors=1,
            key_words=np.zeros((1, kw), np.uint32),
            length=np.full(1, 1 << 30, np.int32),
            rid1=np.zeros(1, np.int32), rid2=np.zeros(1, np.int32),
            gid=np.zeros(1, np.int32), color=np.zeros(1, np.int32),
            pref_lo=np.zeros(1, np.uint32), pref_hi=np.zeros(1, np.uint32),
            bucket_start=np.zeros(1, np.int32), bucket_count=np.zeros(1, np.int32),
            dir_start=ds, dir_bits=db, dir_span_steps=steps,
        )

    # ---- RC augmentation: every entry gets a reverse-complement twin with
    # the SAME gid/payload, so the query probes the forward strand only.
    rc_words = _revcomp_packed(key_words, length, kw)
    key_words = np.concatenate([key_words, rc_words])
    length = np.concatenate([length, length])
    rid1 = np.concatenate([rid1, rid1])
    rid2 = np.concatenate([rid2, rid2])
    gid = np.concatenate([gid, gid])
    # drop duplicates with IDENTICAL payload (palindromic twins); keys
    # equal as strings but with different gids are real double matches and
    # must both stay (they get distinct colors below)
    full = np.concatenate(
        [key_words, length[:, None].astype(np.uint32), gid[:, None].astype(np.uint32)],
        axis=1,
    )
    order = np.lexsort(tuple(full[:, c] for c in range(full.shape[1] - 1, -1, -1)))
    fs = full[order]
    first = np.ones(fs.shape[0], bool)
    first[1:] = (fs[1:] != fs[:-1]).any(axis=1)
    keep = np.sort(order[first])
    key_words, length = key_words[keep], length[keep]
    rid1, rid2, gid = rid1[keep], rid2[keep], gid[keep]
    E = length.shape[0]

    color = _chain_colors(key_words, length, kw)
    n_colors = int(color.max()) + 1

    plo, phi = _prefix_lo_hi(key_words, h)
    hlo, hhi = _hash_prefix(plo, phi)
    # group entries by primary hash (prefixes colliding in hlo merge into
    # one span; the probe-time verify separates them), then secondary
    # hash, then prefix
    order = np.lexsort((length, plo, phi, hhi, hlo))
    key_words = key_words[order]
    length = length[order]
    rid1, rid2 = rid1[order], rid2[order]
    gid, color = gid[order], color[order]
    hlo, hhi = hlo[order], hhi[order]
    # spans: runs of equal hlo (the scannable entry ranges)
    newspan = np.ones(E, bool)
    newspan[1:] = hlo[1:] != hlo[:-1]
    span_id = np.cumsum(newspan) - 1
    sstart = np.nonzero(newspan)[0]
    scount = np.diff(np.concatenate([sstart, [E]]))
    # bucket rows: one per distinct (hlo, hhi); collision rows of one span
    # each reference the FULL span, so a probe joining under any hhi mask
    # width still scans every candidate of its hlo
    newb = np.ones(E, bool)
    newb[1:] = newspan[1:] | (hhi[1:] != hhi[:-1])
    brow = np.nonzero(newb)[0]
    pref_lo_b = hlo[brow].astype(np.uint32)
    ds, db, steps = _build_directory(pref_lo_b)
    return MergedIndex(
        h=h, kw=kw, eu=eu, ed=ed, max_bucket=int(scount.max()),
        n_colors=n_colors,
        key_words=key_words.astype(np.uint32),
        length=length.astype(np.int32),
        rid1=rid1.astype(np.int32), rid2=rid2.astype(np.int32),
        gid=gid.astype(np.int32), color=color.astype(np.int32),
        pref_lo=pref_lo_b, pref_hi=hhi[brow].astype(np.uint32),
        bucket_start=sstart[span_id[brow]].astype(np.int32),
        bucket_count=scount[span_id[brow]].astype(np.int32),
        dir_start=ds, dir_bits=db, dir_span_steps=steps,
    )


NEVER_LEN = 0xFFFF  # erec length field for oversize/pad entries


def _fused_records(key_words, length, color, bucket_start, bucket_count,
                   gid, rid1, rid2):
    elen_pack = (
        np.minimum(length, NEVER_LEN).astype(np.int32)
        | (color.astype(np.int32) << 16)
    )
    erec = np.concatenate(
        [key_words.astype(np.uint32), elen_pack[:, None].astype(np.uint32)],
        axis=1,
    )
    brec = np.stack([bucket_start, bucket_count], axis=-1)
    prec = np.stack([gid, rid1, rid2], axis=-1)
    return erec, brec, prec
