"""Shortest unique / doubly-unique substring extraction (host-numpy engine):
a copy of ``cammiq_tpu/index/unique.py``; the device build's stages are
``index/unique.py``.

Re-derivation of the reference's directional run-sweeps as segmented scans.
Semantics are operation-exact with src/gsa.cpp:

- `compute_gsa`:        GSA[i] = genome id owning text position SA[i]
                        (fillGnrSuffixArray, src/gsa.cpp:60-80).
- `unique_lcp0`:        LCP0[i] per computeGnrLcpArray16/32
                        (src/gsa.cpp:239-309): forward/backward run-scans,
                        el floor on the forward pass, first/last run edge
                        rules.
- `doubly_lcp0`:        LCP0 + second-genome id per computeGnrLcpArray16_d
                        (src/gsa.cpp:311-406) with sentinel ulmax+2.
- `min_unique`:         MU scatter (computeMinUnique, src/gsa.cpp:505-542).
- `occ_unique/doubly`:  own-genome (and pair-genome) occurrence counts
                        (computeOCC16/_d, src/gsa.cpp:544-712).  Default
                        saturates at 255 (the better-behaved choice);
                        `wrap_u8=True` reproduces the reference's uint8
                        wrap-around bit-exactly (BuildConfig.occ_u8_wrap).

Known deviation from uninitialized-memory reference behavior: LCP[0] is
garbage in the reference (Kasai skips rank 0 and the buffer is recycled);
here LCP[0] = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..ops.scans_host import (
    end_index,
    segmented_cummin,
    segmented_cummin_rev,
    start_index,
)

MU_EMPTY = 0xFFFF  # "no unique substring ends here" (memset 0xFF, gsa.cpp:508)
OCC_SATURATE = 255


def compute_gsa(sa: np.ndarray, ref_pos: np.ndarray, ref_id: np.ndarray) -> np.ndarray:
    """Genome (species) id per SA rank.

    sa: int64 [n] suffix array over the corpus (sentinels excluded);
    ref_pos: per-file end positions; ref_id: per-file species ids.
    GSA[i] = ref_id[first j with SA[i] < ref_pos[j]]
    (reference: src/gsa.cpp:60-80).
    """
    j = np.searchsorted(np.asarray(ref_pos, dtype=np.int64), np.asarray(sa, dtype=np.int64), side="right")
    return np.asarray(ref_id, dtype=np.int64)[j]


class RunInfo(NamedTuple):
    starts: np.ndarray   # bool [n]: i starts a run of equal GSA values
    ends: np.ndarray     # bool [n]: i ends a run
    rb: np.ndarray       # int64 [n]: run bottom index
    rt: np.ndarray       # int64 [n]: run top index
    rid: np.ndarray      # int64 [n]: run ordinal
    nruns: int


def run_info(gsa: np.ndarray) -> RunInfo:
    n = gsa.shape[0]
    starts = np.empty(n, dtype=bool)
    starts[0] = True
    starts[1:] = gsa[1:] != gsa[:-1]
    ends = np.empty(n, dtype=bool)
    ends[:-1] = starts[1:]
    ends[-1] = True
    rb = start_index(starts)
    rt = end_index(starts)
    rid = np.cumsum(starts.astype(np.int64)) - 1
    return RunInfo(starts, ends, rb, rt, rid, int(rid[-1]) + 1)


def _direction_mins(lcp: np.ndarray, runs: RunInfo) -> tuple[np.ndarray, np.ndarray]:
    """A[i] = min(LCP[i+1 .. rt(i)+1]): lcp to nearest following
    other-genome suffix; B[i] = min(LCP[rb(i) .. i]): to nearest preceding.
    lcp: int64 [n+1] (lcp[n] = 0)."""
    n = runs.starts.shape[0]
    vA = lcp[1 : n + 1]  # value attached "after" position i
    A = segmented_cummin_rev(vA, runs.ends)
    vB = lcp[:n]
    B = segmented_cummin(vB, runs.starts)
    return A, B


def unique_lcp0(gsa: np.ndarray, lcp: np.ndarray, el: int) -> np.ndarray:
    """LCP0[i]: length-1 of the shortest prefix of suffix SA[i] found in no
    other genome (floored at el except for the final run).

    Matches computeGnrLcpArray16/32 (src/gsa.cpp:239-309) including edge
    semantics: first run = max(el, A); last run = B (no el floor);
    middle = max(el, A, B); single-run corpus = all zeros.
    """
    runs = run_info(gsa)
    n = gsa.shape[0]
    if runs.nruns == 1:
        return np.zeros(n, dtype=np.int64)
    A, B = _direction_mins(np.asarray(lcp, dtype=np.int64), runs)
    first = runs.rid == 0
    last = runs.rid == runs.nruns - 1
    el = np.int64(el)
    out = np.maximum(np.maximum(A, B), el)
    out = np.where(first, np.maximum(A, el), out)
    out = np.where(last, B, out)
    return out


class DoublyResult(NamedTuple):
    lcp0: np.ndarray     # int64 [n] per rank; sentinel = ulmax + 2
    gsa2: np.ndarray     # int64 [n] per TEXT POSITION: candidate 2nd genome


def doubly_lcp0(sa: np.ndarray, gsa: np.ndarray, lcp: np.ndarray,
                el: int, ulmax: int) -> DoublyResult:
    """Doubly-unique LCP0 (computeGnrLcpArray16_d, src/gsa.cpp:311-406).

    Returns per-rank LCP0 (sentinel ulmax+2 where no valid doubly-unique
    prefix exists) and the per-text-position second-genome id GSA2_.
    """
    runs = run_info(gsa)
    n = gsa.shape[0]
    sa = np.asarray(sa, dtype=np.int64)
    lcp = np.asarray(lcp, dtype=np.int64)
    sentinel = np.int64(ulmax + 2)
    gsa2_text = np.zeros(n, dtype=np.int64)
    if runs.nruns == 1:
        return DoublyResult(np.zeros(n, dtype=np.int64), gsa2_text)

    A, B = _direction_mins(lcp, runs)
    first = runs.rid == 0
    last = runs.rid == runs.nruns - 1

    # ---- forward pass (src/gsa.cpp:318-338): A' and candidate g2 = genome
    # of the next run; last run gets 0 / no assignment.
    nxt_top = np.minimum(runs.rt + 1, n - 1)     # first index of next run
    g2_fwd = gsa[nxt_top]                        # valid except last run
    Aprime = np.where(last, 0, A)

    # ---- backward pass (src/gsa.cpp:348-399), all runs except the first.
    # Case 1 (A' < B): g2 = previous run's genome;
    #   m2b[i] = min(LCP[rb(prev run) .. i]) = min(B[i], B[rt(prev run)]).
    prev_top = np.maximum(runs.rb - 1, 0)        # last index of prev run
    g2_bwd = gsa[prev_top]
    B_prev_top = B[prev_top]
    m2b = np.minimum(B, B_prev_top)
    lcp0_case1 = np.maximum(np.maximum(Aprime, m2b), np.int64(el))
    case1 = np.where(lcp0_case1 >= B, sentinel, lcp0_case1)

    # Case 2 (A' > B): g2 stays the next run's genome;
    #   m2f (run-level, computed from the run top) =
    #   min(LCP[rt(run)+1 .. rt(next run)+1]) = min(LCP[rb(next)], A[rb(next)]).
    nxt_bottom = np.minimum(runs.rt + 1, n - 1)  # rb of next run
    m2f = np.minimum(lcp[nxt_bottom], A[nxt_bottom])  # garbage for last run; masked
    lcp0_case2 = np.maximum(np.maximum(B, m2f), np.int64(el))
    case2 = np.where(lcp0_case2 >= Aprime, sentinel, lcp0_case2)

    out = np.where(
        Aprime < B, case1,
        np.where(Aprime > B, case2, sentinel),
    )
    g2_rank = np.where(Aprime < B, g2_bwd, g2_fwd)
    # first run: keep the forward values untouched (reference excludes it
    # from the backward pass: LCP0 = A', g2 = next-run genome).
    out = np.where(first, Aprime, out)
    g2_rank = np.where(first, g2_fwd, g2_rank)

    # scatter g2 to text positions.  The reference writes GSA2_[SA[i]] in
    # the forward pass for every rank and overwrites in backward case 1;
    # ranks that keep g2=0 are: none (fwd writes all except last run; bwd
    # case 1 covers last run when it fires).  Last-run ranks falling into
    # case 2/tie keep 0.
    write = ~last | (Aprime < B)
    gsa2_text[sa[write]] = g2_rank[write]
    return DoublyResult(out, gsa2_text)


def min_unique(sa: np.ndarray, lcp0: np.ndarray, n: int,
               ulmax: int | None = None) -> np.ndarray:
    """MU[e] = min over ranks i with SA[i] + LCP0[i] + 1 == e of LCP0[i].

    MU[e] = (length - 1) of the shortest unique substring ending at text
    position e-1 (computeMinUnique, src/gsa.cpp:505-542).  With ulmax
    given, ranks with LCP0 >= ulmax are skipped (doubly mode).  Targets
    beyond n are dropped (the reference writes into buffer slack; those
    slots are never read back).
    """
    sa = np.asarray(sa, dtype=np.int64)
    lcp0 = np.asarray(lcp0, dtype=np.int64)
    mu = np.full(n + 1, MU_EMPTY, dtype=np.int64)
    tgt = sa + lcp0 + 1
    keep = tgt <= n
    if ulmax is not None:
        keep &= lcp0 < ulmax
    np.minimum.at(mu, tgt[keep], lcp0[keep])
    return mu


def _adjacent_count(lcp: np.ndarray, thresh: np.ndarray, allowed: np.ndarray,
                    max_steps: int | None = OCC_SATURATE) -> tuple[np.ndarray, np.ndarray]:
    """Directional neighbor counting shared by the OCC kernels.

    For each rank i counts, over d = 1..max_steps (unbounded when None):
      up:   allowed(i, i+d) and min(LCP[i+1..i+d]) > thresh[i]
      down: allowed(i, i-d) and min(LCP[i-d+1..i]) > thresh[i]
    `allowed[i, j]` is supplied as a callable on (i, j) index arrays.
    Both conditions are monotone in d, so the count equals the first-failure
    distance; we iterate with an active mask and early-exit.
    Returns (count_up, count_down) int64 [n].
    """
    n = lcp.shape[0] - 1
    idx = np.arange(n, dtype=np.int64)

    def directional(sign: int) -> np.ndarray:
        cnt = np.zeros(n, dtype=np.int64)
        run_min = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        active = idx.copy()
        d = 0
        while active.size and (max_steps is None or d < max_steps):
            d += 1
            j = active + sign * d
            inb = (j >= 0) & (j <= n - 1)
            act = active[inb]
            jj = j[inb]
            if sign > 0:
                crossing = lcp[act + d]        # LCP[i+d] joins step d
            else:
                crossing = lcp[act - d + 1]    # LCP[i-d+1] joins step d
            run_min[act] = np.minimum(run_min[act], crossing)
            ok = allowed(act, jj) & (run_min[act] > thresh[act])
            cnt[act[ok]] += 1
            active = act[ok]
        return cnt

    return directional(+1), directional(-1)


def occ_unique(sa: np.ndarray, gsa: np.ndarray, lcp: np.ndarray,
               lcp0: np.ndarray, wrap_u8: bool = False) -> np.ndarray:
    """Own-genome occurrence count of each rank's shortest unique prefix,
    scattered to text positions (computeOCC16/32, src/gsa.cpp:544-614).
    occ init 1 (itself); counts adjacent same-genome ranks whose running
    min LCP exceeds LCP0.

    wrap_u8: bit-parity mode - emulate the reference's uint8 counters
    wrapping mod 256 (occ is uint8_t*, src/gsa.cpp:546) instead of
    saturating at 255."""
    n = gsa.shape[0]
    sa = np.asarray(sa, dtype=np.int64)
    lcp = np.asarray(lcp, dtype=np.int64)

    def same_genome(i, j):
        return gsa[i] == gsa[j]

    up, down = _adjacent_count(
        lcp, np.asarray(lcp0, dtype=np.int64), same_genome,
        max_steps=None if wrap_u8 else OCC_SATURATE,
    )
    if wrap_u8:
        occ_rank = (1 + up + down) & 0xFF
    else:
        occ_rank = np.minimum(1 + up + down, OCC_SATURATE)
    occ = np.zeros(n, dtype=np.int64)
    occ[sa] = occ_rank
    return occ


def occ_doubly(sa: np.ndarray, gsa: np.ndarray, gsa2_text: np.ndarray,
               lcp: np.ndarray, lcp0: np.ndarray, ulmax: int,
               wrap_u8: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Pair occurrence counts (computeOCC16_d, src/gsa.cpp:616-663).
    wrap_u8: emulate uint8 counter wrap-around (bit-parity mode).

    occ[p]  = occurrences of the doubly-unique substring at p within its
              own genome (init 1);
    occ2[p] = occurrences within the second genome (init 0).
    Only ranks with LCP0 <= ulmax in (rt(first run), n-1] are processed;
    the scan walks while the neighbor's genome is in {g, g2}, counting
    whichever side matches while the running min LCP > LCP0.
    """
    n = gsa.shape[0]
    sa = np.asarray(sa, dtype=np.int64)
    lcp = np.asarray(lcp, dtype=np.int64)
    lcp0 = np.asarray(lcp0, dtype=np.int64)
    runs = run_info(gsa)
    g2_rank = gsa2_text[sa]          # second genome per rank
    end_excl = runs.rt[0]            # top of the first run (gsa.cpp:625-626)

    processed = (lcp0 <= ulmax) & (np.arange(n) > end_excl)

    # allowed: neighbor genome in {g, g2}; the scan itself also must not
    # walk past rank end_excl downward / n-1 upward (handled by bounds).
    def allowed_up(i, j):
        return (gsa[j] == gsa[i]) | (gsa[j] == g2_rank[i])

    def allowed_down(i, j):
        # the reference walk reaches neighbors down to rank `end` inclusive
        # (loop guard i - j > end with neighbor i - j - 1, gsa.cpp:634)
        return (j >= end_excl) & ((gsa[j] == gsa[i]) | (gsa[j] == g2_rank[i]))

    # Unlike the unique OCC, the walk continues while the genome matches
    # even after the min LCP drops; but the count condition is monotone so
    # counting-with-early-stop equals counting-with-continue *only* if once
    # min <= LCP0, later steps can't count.  The min is nonincreasing, so
    # equality holds.
    def count_dir(sign, allowed):
        idx = np.arange(n, dtype=np.int64)
        cnt1 = np.zeros(n, dtype=np.int64)
        cnt2 = np.zeros(n, dtype=np.int64)
        run_min = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        active = idx[processed]
        d = 0
        # Once run_min <= lcp0 an active rank can never count again (the
        # running min is nonincreasing), so it is dropped even though the
        # reference keeps walking; the counts are identical.  Each
        # surviving step counts on one side, so <= 2*255 + 1 steps matter.
        while active.size and (wrap_u8 or d <= 2 * OCC_SATURATE):
            d += 1
            j = active + sign * d
            inb = (j >= 0) & (j <= n - 1)
            act = active[inb]
            jj = j[inb]
            okg = allowed(act, jj)
            act, jj = act[okg], jj[okg]
            if sign > 0:
                crossing = lcp[act + d]
            else:
                crossing = lcp[act - d + 1]
            run_min[act] = np.minimum(run_min[act], crossing)
            counting = run_min[act] > lcp0[act]
            c1 = counting & (gsa[jj] == gsa[act])
            c2 = counting & (gsa[jj] == g2_rank[act])
            cnt1[act[c1]] += 1
            cnt2[act[c2]] += 1
            active = act[counting]
        return cnt1, cnt2

    u1, u2 = count_dir(+1, allowed_up)
    d1, d2 = count_dir(-1, allowed_down)
    if wrap_u8:
        occ_rank = np.where(processed, (1 + u1 + d1) & 0xFF, 0)
        occ2_rank = np.where(processed, (u2 + d2) & 0xFF, 0)
    else:
        occ_rank = np.where(processed, np.minimum(1 + u1 + d1, OCC_SATURATE), 0)
        occ2_rank = np.where(processed, np.minimum(u2 + d2, OCC_SATURATE), 0)
    occ = np.zeros(n, dtype=np.int64)
    occ2 = np.zeros(n, dtype=np.int64)
    occ[sa] = occ_rank
    occ2[sa] = occ2_rank
    return occ, occ2
