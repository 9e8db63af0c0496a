"""Sparsified index selection + unique-L-mer counting: a copy of
``cammiq_tpu/index/sparsify.py`` (without the sharded-build hook
``start_file``).

Operational port of the reference's computeIndexmin / computeIndexmin_d(_)
(src/build.cpp:336-629): walk candidate end-positions (MU-set) in text
order; maintain the greedy covering state (start_, last{j,l,r}) so that
every unique L-mer contains at least one emitted substring; count unique
L-mers per genome file with contig-boundary corrections.

Group semantics: the reference partitions genome files over min(t, 4)
pthreads and resets the walk state per thread (src/build.cpp:660,344-348).
`num_groups` reproduces that partition deterministically (sequentially).

The unique variant of the reference advances at most one contig boundary
per candidate (`if`, src/build.cpp:362) while the doubly variants loop
(`while`, src/build.cpp:460); the default here loops for both (the only
difference is when a candidate jumps two contig boundaries at once, i.e.
contigs shorter than ~L), and `unique_if_advance=True` reproduces the
reference's `if` bit-exactly (BuildConfig.unique_if_advance).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..io.fasta import Corpus
from ..ops.packing import BASE_OFFSET

MU_EMPTY = 0xFFFF  # no minimal unique substring ends here (uint16 max)

# ASCII codes of A, C, G, T after the +165 offset (mod 256)
_ACGT_OFFSET = {(65 + BASE_OFFSET) % 256, (67 + BASE_OFFSET) % 256,
                (71 + BASE_OFFSET) % 256, (84 + BASE_OFFSET) % 256}


@dataclasses.dataclass
class SelectedSubstrings:
    """Emitted index substrings + per-file unique-L-mer counts."""

    start: np.ndarray      # int64 [S] text position of substring start
    length: np.ndarray     # int64 [S]
    rid: np.ndarray        # int64 [S] genome (species) id
    occ: np.ndarray        # int64 [S] own-genome occurrence count
    rid2: np.ndarray       # int64 [S] second genome id (0 for unique index)
    occ2: np.ndarray       # int64 [S]
    ulm_count: np.ndarray  # int64 [M] unique-L-mer count per genome FILE

    @property
    def size(self) -> int:
        return int(self.start.shape[0])


def _group_spans(ref_pos, M: int, num_groups: int):
    """Selection-group text spans [(i0, nexti, first_file)]."""
    ref_pos = np.asarray(ref_pos, np.int64)
    nref = M // num_groups
    out = []
    for tid in range(num_groups):
        i0 = 1 if tid == 0 else int(ref_pos[tid * nref - 1])
        nexti = (int(ref_pos[M - 1]) if tid == num_groups - 1
                 else int(ref_pos[(tid + 1) * nref - 1]))
        out.append((i0, nexti, tid * nref))
    return out


def _is_acgt(seq: np.ndarray) -> np.ndarray:
    ok = np.zeros(256, dtype=bool)
    for v in _ACGT_OFFSET:
        ok[v] = True
    return ok[seq]


def select_substrings(
    corpus: Corpus,
    mu: np.ndarray,
    occ: np.ndarray,
    L: int,
    Lmax: int,
    gsa2_text: Optional[np.ndarray] = None,
    occ2: Optional[np.ndarray] = None,
    num_groups: int = 1,
    engine: str = "auto",
    unique_if_advance: bool = False,
) -> SelectedSubstrings:
    """Sparsified selection; engine='fast' uses the vectorized path
    (identical output, see select_substrings_fast), 'exact' the scalar
    reference transcription, 'auto'/'native' the C++ sweep when built
    (an explicit 'fast' is honored even when the native library exists,
    so the vectorized path keeps test coverage).

    unique_if_advance: bit-parity mode - reproduce the reference's
    `if`-advance over contig boundaries in the UNIQUE variant
    (src/build.cpp:362; the doubly variants loop, src/build.cpp:460).
    Only differs when a candidate jumps two contig boundaries at once
    (contigs shorter than ~L).

    engine='native' (auto-picked when the C++ library is built) runs the
    O(n)-time / O(1)-memory sweep in native/sweeps.cpp - the production
    path at multi-GB corpus scale."""
    if engine in ("auto", "native"):
        from .. import native as _native

        if _native.available():
            starts, lens, ris, ulm = _native.select_sweep(
                corpus.seq, mu,
                corpus.contig_pos, corpus.ref_pos, L, Lmax,
                num_groups=max(1, min(num_groups, 4, corpus.num_files)),
                unique_if_advance=unique_if_advance and gsa2_text is None,
            )
            occ = np.asarray(occ)
            occ_sel = occ[starts].astype(np.int64) if starts.size else np.zeros(0, np.int64)
            if gsa2_text is not None:
                rid2_sel = np.asarray(gsa2_text)[starts].astype(np.int64) if starts.size else np.zeros(0, np.int64)
                occ2_sel = np.asarray(occ2)[starts].astype(np.int64) if starts.size else np.zeros(0, np.int64)
            else:
                rid2_sel = np.zeros(starts.size, np.int64)
                occ2_sel = np.zeros(starts.size, np.int64)
            ref_id = corpus.ref_id.astype(np.int64)
            return SelectedSubstrings(
                start=starts.astype(np.int64),
                length=lens.astype(np.int64),
                rid=ref_id[ris],
                occ=occ_sel, rid2=rid2_sel, occ2=occ2_sel,
                ulm_count=ulm,
            )
    if engine in ("auto", "native"):
        engine = "fast"  # requested/auto native, library not built
    if unique_if_advance and gsa2_text is None:
        engine = "exact"
    if engine == "fast":
        return select_substrings_fast(
            corpus, mu, occ, L, Lmax, gsa2_text=gsa2_text, occ2=occ2,
            num_groups=num_groups,
        )
    return select_substrings_exact(
        corpus, mu, occ, L, Lmax, gsa2_text=gsa2_text, occ2=occ2,
        num_groups=num_groups,
        unique_if_advance=unique_if_advance and gsa2_text is None,
    )


def select_substrings_exact(
    corpus: Corpus,
    mu: np.ndarray,
    occ: np.ndarray,
    L: int,
    Lmax: int,
    gsa2_text: Optional[np.ndarray] = None,
    occ2: Optional[np.ndarray] = None,
    num_groups: int = 1,
    unique_if_advance: bool = False,
) -> SelectedSubstrings:
    """Reference-exact sequential engine (src/build.cpp:336-629).

    mu: int array [n+1] (MU_EMPTY where unset); occ/occ2/gsa2_text indexed
    by text position.  Pass gsa2_text/occ2 for the doubly variant.
    unique_if_advance: advance at most ONE contig boundary per candidate,
    the reference's unique-variant `if` (src/build.cpp:362).
    """
    contig_pos = corpus.contig_pos.astype(np.int64)
    ref_pos = corpus.ref_pos.astype(np.int64)
    ref_id = corpus.ref_id.astype(np.int64)
    seq = corpus.seq
    M = len(ref_pos)
    C = len(contig_pos)
    num_groups = max(1, min(num_groups, 4, M))
    doubly = gsa2_text is not None

    acgt = _is_acgt(seq)
    # prefix sums for O(1) "window all ACGT" tests
    acgt_cum = np.concatenate([[0], np.cumsum(acgt.astype(np.int64))])

    ulm = np.zeros(M, dtype=np.int64)
    exist_unique = np.ones(C, dtype=bool)
    out_start: List[int] = []
    out_len: List[int] = []
    out_rid: List[int] = []
    out_occ: List[int] = []
    out_rid2: List[int] = []
    out_occ2: List[int] = []

    mu = np.asarray(mu)
    cand_pos = np.nonzero(mu[: int(ref_pos[-1])] != MU_EMPTY)[0]
    cand_pos = cand_pos[cand_pos >= 1]

    groups = _group_spans(ref_pos, M, num_groups)
    for i0, nexti, ri0 in groups:
        ci = int(np.searchsorted(contig_pos, i0, side="right"))
        ri = ri0
        lastr = ri
        start = 0
        start_ = 0
        lastj = 0
        lastl = 0

        lo = int(np.searchsorted(cand_pos, i0, side="left"))
        hi = int(np.searchsorted(cand_pos, nexti, side="left"))
        for i in cand_pos[lo:hi]:
            i = int(i)
            j = i - int(mu[i])

            # contig separator region (src/build.cpp:362-377 / 460-475)
            while ci < C and i >= contig_pos[ci] - 4:
                if start + L + 2 >= contig_pos[ci] and exist_unique[ci]:
                    corr = start + L + 3 - int(contig_pos[ci])
                    ulm[ri if ri == lastr else lastr] -= corr
                start = max(int(contig_pos[ci]), i - L)
                ci += 1
                if ci >= C:
                    break
                if ri < M and i >= ref_pos[ri] - 4:
                    ri += 1
                if start + L + 2 >= contig_pos[ci]:
                    exist_unique[ci] = False
                if unique_if_advance:
                    break
            if ci >= C:
                break

            # substring spans two contigs (src/build.cpp:380-383)
            if ci > 0 and j - 1 < contig_pos[ci - 1]:
                continue
            # substring contains non-ACGT (src/build.cpp:386-398)
            if acgt_cum[i] - acgt_cum[j - 1] != i - (j - 1):
                continue
            # substring too long (src/build.cpp:401-405)
            length = i - j + 1
            if length > Lmax:
                continue

            # greedy covering insert (src/build.cpp:407-414)
            if i > start_ + L and lastl > 0:
                p0 = lastj - 1
                out_start.append(p0)
                out_len.append(lastl)
                out_rid.append(int(ref_id[lastr]))
                out_occ.append(int(occ[p0]))
                if doubly:
                    out_rid2.append(int(gsa2_text[p0]))
                    out_occ2.append(int(occ2[p0]))
                else:
                    out_rid2.append(0)
                    out_occ2.append(0)
                start_ = lastj

            # unique L-mer aggregation (src/build.cpp:416-423)
            if i <= start + L:
                ulm[ri] += j - start
            else:
                ulm[ri] += j + L - i
            start = j

            lastr = ri
            lastl = length
            lastj = j

    return SelectedSubstrings(
        start=np.asarray(out_start, dtype=np.int64),
        length=np.asarray(out_len, dtype=np.int64),
        rid=np.asarray(out_rid, dtype=np.int64),
        occ=np.asarray(out_occ, dtype=np.int64),
        rid2=np.asarray(out_rid2, dtype=np.int64),
        occ2=np.asarray(out_occ2, dtype=np.int64),
        ulm_count=ulm,
    )


def select_substrings_fast(
    corpus: Corpus,
    mu: np.ndarray,
    occ: np.ndarray,
    L: int,
    Lmax: int,
    gsa2_text: Optional[np.ndarray] = None,
    occ2: Optional[np.ndarray] = None,
    num_groups: int = 1,
) -> SelectedSubstrings:
    """Vectorized engine, output-identical to select_substrings_exact.

    Key observations that remove the sequential state:
    - the candidate's contig/genome context is stateless:
      ci(i) = first c with i < contig_pos[c] - 4 (the while-advance fixed
      point), ri(i) likewise on ref_pos;
    - the validity filters (contig span / non-ACGT / length) are pure
      per-candidate predicates;
    - the greedy covering inserts form a jump chain driven only by
      (start_, previous candidate), walked with searchsorted per INSERT
      (#inserts ~ n/L);
    - the unique-L-mer contribution of a non-boundary candidate is
      min(j_p - j_{p-1}, j_p + L - i_p); only boundary-crossing candidates
      (#contigs many) need the scalar while-loop replay for the start
      resets, corrections and exist_unique flags.
    """
    contig_pos = corpus.contig_pos.astype(np.int64)
    ref_pos = corpus.ref_pos.astype(np.int64)
    ref_id = corpus.ref_id.astype(np.int64)
    seq = corpus.seq
    M = len(ref_pos)
    C = len(contig_pos)
    num_groups = max(1, min(num_groups, 4, M))
    doubly = gsa2_text is not None

    acgt = _is_acgt(seq)
    acgt_cum = np.concatenate([[0], np.cumsum(acgt.astype(np.int64))])

    mu = np.asarray(mu)
    n = int(ref_pos[-1])
    cand_all = np.nonzero(mu[:n] != MU_EMPTY)[0]
    cand_all = cand_all[cand_all >= 1]

    ulm = np.zeros(M, dtype=np.int64)
    exist_unique = np.ones(C, dtype=bool)
    sel_start: List[np.ndarray] = []
    sel_len: List[np.ndarray] = []
    sel_ri: List[np.ndarray] = []

    cp4 = contig_pos - 4
    rp4 = ref_pos - 4

    for i0, nexti, ri0 in _group_spans(ref_pos, M, num_groups):
        lo = int(np.searchsorted(cand_all, i0, side="left"))
        hi = int(np.searchsorted(cand_all, nexti, side="left"))
        iv = cand_all[lo:hi]
        if iv.size == 0:
            continue
        jv = iv - mu[iv]

        # stateless contig/genome context AFTER boundary processing
        ci_s = np.searchsorted(cp4, iv, side="right")
        ri_s = np.searchsorted(rp4, iv, side="right")
        # candidates that would run the group off the contig table stop
        # the group (reference: break when ci >= C)
        stop = ci_s >= C
        if stop.any():
            # everything from the first stopping candidate on is dropped
            # after its boundary replay; find cutoff
            cut = int(np.argmax(stop))
        else:
            cut = iv.size

        # ---- validity filters ----
        prev_cp = np.where(ci_s > 0, contig_pos[np.maximum(ci_s - 1, 0)], 0)
        ok_span = ~((ci_s > 0) & (jv - 1 < prev_cp))
        ok_acgt = (acgt_cum[iv] - acgt_cum[jv - 1]) == (iv - (jv - 1))
        lv = iv - jv + 1
        ok_len = lv <= Lmax
        valid = ok_span & ok_acgt & ok_len
        valid[cut:] = False

        vi = iv[valid]
        vj = jv[valid]
        vl = lv[valid]
        vri = ri_s[valid]
        # the candidate at the stop boundary also runs its replay; keep
        # boundary replay over the full pre-cut candidate list below.

        # ---- greedy covering inserts (jump chain over valid candidates) ----
        P = vi.size
        start_ = 0
        p_prev = -1
        picks = []
        while True:
            p = int(np.searchsorted(vi, start_ + L, side="right"))
            p = max(p, p_prev + 1)
            if p >= P:
                break
            if p >= 1:
                picks.append(p - 1)
                start_ = int(vj[p - 1])
            p_prev = p
        if picks:
            pk = np.asarray(picks, dtype=np.int64)
            sel_start.append(vj[pk] - 1)
            sel_len.append(vl[pk])
            sel_ri.append(vri[pk])

        # ---- unique-L-mer aggregation ----
        # NOTE: boundary processing happens for every candidate (valid or
        # not) in the reference; an invalid candidate can advance ci and
        # reset start.  Track context from the full candidate list:
        ci_init = int(np.searchsorted(contig_pos, i0, side="right"))
        ci_prev_full = np.empty(iv.size, dtype=np.int64)
        ci_prev_full[0] = ci_init
        ci_prev_full[1:] = ci_s[:-1]
        crossed_full = ci_s > ci_prev_full

        # start_prev for each valid candidate:
        #   no boundary since previous VALID candidate -> j of previous
        #   valid candidate in the same "no-crossing span"... but an
        #   invalid candidate between them may have crossed a boundary and
        #   reset start.  Handle by tracking the last start-reset event
        #   index over the full candidate list.
        idx_full = np.arange(iv.size)
        reset_at = np.where(crossed_full, idx_full, -1)
        last_reset = np.maximum.accumulate(reset_at)
        # start value established by a reset at full-candidate q:
        # max(contig_pos[ci_s[q]-1], iv[q]-L)
        reset_start = np.maximum(
            np.where(ci_s > 0, contig_pos[np.maximum(ci_s - 1, 0)], 0),
            iv - L,
        )
        # previous valid candidate (full index) per valid candidate
        valid_idx_full = idx_full[valid]
        if P > 0:
            prev_valid_full = np.concatenate([[-1], valid_idx_full[:-1]])
            lr = last_reset[valid_idx_full]
            use_reset = lr > prev_valid_full
            prev_j = np.concatenate([[0], vj[:-1]])
            start_prev = np.where(use_reset, reset_start[np.maximum(lr, 0)], prev_j)
            contrib = np.minimum(vj - start_prev, vj + L - vi)
            np.add.at(ulm, vri, contrib)

        # ---- boundary replay: corrections + exist_unique flags ----
        # replay the while-loop for each boundary-crossing candidate
        # the reference subtracts from uLmcount[ri == lastr ? ri : lastr],
        # which is always lastr: the genome of the last valid candidate
        cross_idx = idx_full[crossed_full]
        cross_idx = cross_idx[cross_idx <= cut]
        if cross_idx.size:
            for q in cross_idx:
                i = int(iv[q])
                pv = int(np.searchsorted(valid_idx_full, q) - 1)
                # start value before this candidate's boundary block
                lrq = int(last_reset[q - 1]) if q > 0 else -1
                if pv >= 0 and lrq <= int(valid_idx_full[pv]):
                    start = int(vj[pv])
                elif lrq >= 0:
                    start = int(reset_start[lrq])
                else:
                    start = 0
                ci = int(ci_prev_full[q])
                lastr = int(vri[pv]) if pv >= 0 else ri0
                while ci < C and i >= contig_pos[ci] - 4:
                    if start + L + 2 >= contig_pos[ci] and exist_unique[ci]:
                        ulm[lastr] -= start + L + 3 - int(contig_pos[ci])
                    start = max(int(contig_pos[ci]), i - L)
                    ci += 1
                    if ci >= C:
                        break
                    if start + L + 2 >= contig_pos[ci]:
                        exist_unique[ci] = False

    if sel_start:
        starts = np.concatenate(sel_start)
        lens = np.concatenate(sel_len)
        ris = np.concatenate(sel_ri)
    else:
        starts = np.zeros(0, np.int64)
        lens = np.zeros(0, np.int64)
        ris = np.zeros(0, np.int64)

    occ_sel = occ[starts] if starts.size else np.zeros(0, np.int64)
    if doubly:
        rid2_sel = gsa2_text[starts] if starts.size else np.zeros(0, np.int64)
        occ2_sel = occ2[starts] if starts.size else np.zeros(0, np.int64)
    else:
        rid2_sel = np.zeros(starts.size, np.int64)
        occ2_sel = np.zeros(starts.size, np.int64)

    return SelectedSubstrings(
        start=starts.astype(np.int64),
        length=lens.astype(np.int64),
        rid=ref_id[ris],
        occ=np.asarray(occ_sel, dtype=np.int64),
        rid2=np.asarray(rid2_sel, dtype=np.int64),
        occ2=np.asarray(occ2_sel, dtype=np.int64),
        ulm_count=ulm,
    )
