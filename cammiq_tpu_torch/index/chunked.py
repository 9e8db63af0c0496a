"""Chunk-carried streaming sweeps: LCP0/OCC/MU over SA order WITHOUT
materializing any full-corpus array.  A copy of
``cammiq_tpu/index/chunked.py`` over the host twins (``index/unique_host.py``,
``ops/scans_host.py``).

The cross-host build (parallel/dist_build.py) leaves the merged bounded
SA order as per-owner CHUNK files (pos, gid, lcp).  This module runs the
uniqueness pipeline (the math of index/unique_host.py, reference
src/gsa.cpp:239-712) as streaming passes over those chunks:

- forward pass:  per-rank B (min LCP back to the run start) and
  previous-run summaries, carried across chunk boundaries as O(1) state
  — the reference proves per-thread carried scans work
  (src/gsa.cpp:145-167, 318-399); this is the same idea with chunks as
  the parallel unit and disk as the exchange medium;
- backward pass: per-rank A (min LCP forward to the run end) and
  next-run summaries, then LCP0 (unique + doubly with the ulmax+2
  sentinel and GSA2 candidate) in the same sweep;
- OCC+emit pass: per-chunk windows with a +-(2*OCC_SATURATE+2)-rank halo
  — the saturating counters bound the walk, so a fixed halo is exact
  (wrap_u8 bit-parity mode needs unbounded walks; the dist path rejects
  it) — then one record per candidate rank (pos, lcp0, occ[, occ2, g2])
  binned by TEXT shard, so the genome-partitioned selection phase reads
  only its shard's records.

Conventions match index/unique_host.py: the global lcp array is [n+1] with
lcp[0] = lcp[n] = 0 and lcp[i] = LCP(SA[i-1], SA[i]); chunk c's lcp file
holds lcp[c0:c1].  Peak memory of every pass is O(chunk + halo).
Exactness vs the monolithic engines is property-tested over random
(gsa, lcp, chunking) in tests/test_chunked.py (the source) and
tests/test_torch_hostbuild.py (this copy).
"""

from __future__ import annotations

import os

import numpy as np

from .unique_host import OCC_SATURATE, occ_doubly, occ_unique

HALO = 2 * OCC_SATURATE + 2   # occ_doubly walks at most 2*255+1 steps


def _ch(workdir: str, c: int, name: str) -> str:
    return os.path.join(workdir, f"ch{c:04d}_{name}.npy")


def _load(workdir: str, c: int, name: str, mmap: bool = False):
    return np.load(_ch(workdir, c, name), mmap_mode="r" if mmap else None)


def _save(workdir: str, c: int, name: str, arr: np.ndarray) -> None:
    np.save(_ch(workdir, c, name), arr)


def forward_pass(workdir: str, nchunks: int) -> int:
    """Per chunk: B (min lcp back to the run start), prevg/prevB (the
    genome and full-run B of the PREVIOUS run, per rank), rid (global
    run id, int64).  Returns the total run count."""
    from ..ops.scans_host import segmented_cummin

    g_cur = None      # genome of the run open at the chunk boundary
    cur_min = 0       # min lcp over the open run's rows seen so far
    prev_g = -1       # completed summary of the run before the open one
    prev_B = 0
    next_rid = 0      # id the next NEW run will take
    for c in range(nchunks):
        gid = _load(workdir, c, "gid").astype(np.int64)
        lcp = _load(workdir, c, "lcp").astype(np.int64)
        m = gid.shape[0]
        if m == 0:
            _save(workdir, c, "B", np.zeros(0, np.int64))
            _save(workdir, c, "prevg", np.zeros(0, np.int64))
            _save(workdir, c, "prevB", np.zeros(0, np.int64))
            _save(workdir, c, "rid", np.zeros(0, np.int64))
            continue
        starts = np.empty(m, bool)
        starts[0] = (g_cur is None) or (gid[0] != g_cur)
        np.not_equal(gid[1:], gid[:-1], out=starts[1:])
        rid = next_rid + np.cumsum(starts.astype(np.int64)) - 1
        B = segmented_cummin(lcp, starts)
        sidx = np.nonzero(starts)[0]
        if not starts[0]:
            upto = sidx[0] if sidx.size else m
            B[:upto] = np.minimum(B[:upto], cur_min)
        # local runs: first rows fr[j]; run 0 may continue the open run
        fr = sidx if starts[0] else np.concatenate([[0], sidx])
        R = fr.shape[0]
        pg_run = np.empty(R, np.int64)
        pB_run = np.empty(R, np.int64)
        if starts[0] and g_cur is not None:
            # row 0 opens a NEW run: its previous run is the one that was
            # open at the boundary (completed at the last row of the
            # previous chunk, full B = cur_min)
            pg_run[0] = g_cur
            pB_run[0] = cur_min
        else:
            pg_run[0] = prev_g
            pB_run[0] = prev_B
        if R > 1:
            pg_run[1:] = gid[fr[1:] - 1]
            pB_run[1:] = B[fr[1:] - 1]
        lrow = (rid - rid[0]).astype(np.int64)
        _save(workdir, c, "B", B)
        _save(workdir, c, "prevg", pg_run[lrow])
        _save(workdir, c, "prevB", pB_run[lrow])
        _save(workdir, c, "rid", rid)
        # carries
        g_cur = int(gid[-1])
        cur_min = int(B[-1])
        prev_g = int(pg_run[-1])
        prev_B = int(pB_run[-1])
        next_rid = int(rid[-1]) + 1
    return next_rid


def backward_pass(workdir: str, nchunks: int, nruns: int,
                  el: int, ulmax: int, mode: str) -> None:
    """A (min lcp forward to the run end) with right-carries, then LCP0
    in the same sweep.  Writes A, and per mode: lcp0u / lcp0d, g2r, g2w."""
    from ..ops.scans_host import segmented_cummin_rev

    sentinel = np.int64(ulmax + 2)
    elv = np.int64(el)
    g_cur = None      # genome of the run open toward the left boundary
    cur_minA = 0      # min vA over that run's rows right of the boundary
    nxt_g = -1        # summary of the run AFTER the open run
    nxt_m2f = 0
    g_b = -1          # boundary row (c1) info: genome, A, lcp
    A_b = 0
    lcp_b = 0
    lcp_right = 0     # lcp[c1] (lcp[n] = 0 for the last chunk)
    for c in range(nchunks - 1, -1, -1):
        gid = _load(workdir, c, "gid").astype(np.int64)
        lcp = _load(workdir, c, "lcp").astype(np.int64)
        B = _load(workdir, c, "B")
        pg = _load(workdir, c, "prevg")
        pB = _load(workdir, c, "prevB")
        rid = _load(workdir, c, "rid")
        m = gid.shape[0]
        if m == 0:
            for name, dt in (("A", np.int64), ("lcp0u", np.int64),
                             ("lcp0d", np.int64), ("g2r", np.int64)):
                _save(workdir, c, name, np.zeros(0, dt))
            _save(workdir, c, "g2w", np.zeros(0, bool))
            continue
        vA = np.empty(m, np.int64)
        vA[:-1] = lcp[1:]
        vA[-1] = lcp_right
        ends = np.empty(m, bool)
        np.not_equal(gid[1:], gid[:-1], out=ends[:-1])
        ends[-1] = (g_cur is None) or (gid[-1] != g_cur)
        A = segmented_cummin_rev(vA, ends)
        eidx = np.nonzero(ends)[0]
        if not ends[-1]:
            frm = eidx[-1] + 1 if eidx.size else 0
            A[frm:] = np.minimum(A[frm:], cur_minA)
        # local runs by END row er[j]; the run containing row m-1 may
        # continue right (no end row in chunk)
        er = eidx
        cont = not ends[-1]
        R = er.shape[0] + (1 if cont else 0)
        ng_run = np.empty(R, np.int64)
        nm_run = np.empty(R, np.int64)
        for j in range(er.shape[0]):
            e = er[j]
            if e < m - 1:
                nb = e + 1
                ng_run[j] = gid[nb]
                nm_run[j] = min(int(lcp[nb]), int(A[nb]))
            else:   # run ends exactly at the chunk boundary
                ng_run[j] = g_b
                nm_run[j] = min(int(lcp_b), int(A_b)) if g_b >= 0 else 0
        if cont:
            ng_run[-1] = nxt_g
            nm_run[-1] = nxt_m2f
        # map rows to local runs (run j covers (er[j-1], er[j]])
        lrow = np.searchsorted(er, np.arange(m), side="left")
        ng = ng_run[np.minimum(lrow, R - 1)]
        nm2f = nm_run[np.minimum(lrow, R - 1)]
        first = rid == 0
        last = rid == nruns - 1
        _save(workdir, c, "A", A)
        if nruns == 1:
            if mode in ("unique", "both"):
                _save(workdir, c, "lcp0u", np.zeros(m, np.int64))
            if mode in ("doubly_unique", "both"):
                _save(workdir, c, "lcp0d", np.zeros(m, np.int64))
                _save(workdir, c, "g2r", np.zeros(m, np.int64))
                _save(workdir, c, "g2w", np.zeros(m, bool))
        else:
            if mode in ("unique", "both"):
                out = np.maximum(np.maximum(A, B), elv)
                out = np.where(first, np.maximum(A, elv), out)
                out = np.where(last, B, out)
                _save(workdir, c, "lcp0u", out)
            if mode in ("doubly_unique", "both"):
                Aprime = np.where(last, 0, A)
                m2b = np.minimum(B, pB)
                lcp0_case1 = np.maximum(np.maximum(Aprime, m2b), elv)
                case1 = np.where(lcp0_case1 >= B, sentinel, lcp0_case1)
                lcp0_case2 = np.maximum(np.maximum(B, nm2f), elv)
                case2 = np.where(lcp0_case2 >= Aprime, sentinel,
                                 lcp0_case2)
                outd = np.where(Aprime < B, case1,
                                np.where(Aprime > B, case2, sentinel))
                g2r = np.where(Aprime < B, pg, ng)
                outd = np.where(first, Aprime, outd)
                g2r = np.where(first, ng, g2r)
                write = ~last | (Aprime < B)
                _save(workdir, c, "lcp0d", outd)
                _save(workdir, c, "g2r", np.maximum(g2r, 0))
                _save(workdir, c, "g2w", write)
        # carries for the chunk to the left
        g_cur = int(gid[0])
        cur_minA = int(A[0])
        nxt_g = int(ng[0])
        nxt_m2f = int(nm2f[0])
        g_b, A_b, lcp_b = int(gid[0]), int(A[0]), int(lcp[0])
        lcp_right = int(lcp[0])


def occ_emit_pass(workdir: str, nchunks: int, n: int, ulmax: int,
                  mode: str, text_cuts: np.ndarray, end_excl: int) -> None:
    """OCC via haloed windows, then per-candidate records binned by text
    shard:
      ut_{c}_{s}.npy  int64 [k, 3]  (pos, lcp0, occ)
      dt_{c}_{s}.npy  int64 [k, 5]  (pos, lcp0, occ, occ2, g2)
    end_excl: global rank of the first run's top (occ_doubly excludes
    ranks <= end_excl, src/gsa.cpp:625-626).  The selection phase reads
    occ/occ2/g2 only at candidate START positions (= pos of the emitting
    rank), so one record per candidate carries everything it needs."""
    sizes = [int(_load(workdir, c, "gid", mmap=True).shape[0])
             for c in range(nchunks)]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    nsh = text_cuts.shape[0] - 1

    def win(name, lo, hi):
        parts = []
        for cc in range(nchunks):
            a, b = int(offs[cc]), int(offs[cc + 1])
            s, e = max(lo, a), min(hi, b)
            if s < e:
                parts.append(np.asarray(
                    _load(workdir, cc, name, mmap=True)[s - a:e - a]))
        return (np.concatenate(parts) if parts else np.zeros(0, np.int64))

    for c in range(nchunks):
        lo, hi = int(offs[c]), int(offs[c + 1])
        empty3 = np.zeros((0, 3), np.int64)
        empty5 = np.zeros((0, 5), np.int64)
        if hi == lo:
            for s in range(nsh):
                if mode in ("unique", "both"):
                    np.save(os.path.join(workdir, f"ut_{c:04d}_{s:03d}.npy"),
                            empty3)
                if mode in ("doubly_unique", "both"):
                    np.save(os.path.join(workdir, f"dt_{c:04d}_{s:03d}.npy"),
                            empty5)
            continue
        wlo, whi = max(lo - HALO, 0), min(hi + HALO, n)
        gid_w = win("gid", wlo, whi).astype(np.int64)
        lcp_w = np.concatenate([win("lcp", wlo, whi).astype(np.int64), [0]])
        # lcp window convention: occ kernels index lcp up to [mw]; the
        # appended 0 stands in for lcp[whi] — only halo-edge ranks read
        # it, and core ranks never walk past the halo
        if whi < n:
            lcp_w[-1] = int(np.asarray(win("lcp", whi, whi + 1))[0])
        pos_w = win("pos", wlo, whi).astype(np.int64)
        core = slice(lo - wlo, hi - wlo)
        mw = gid_w.shape[0]
        ident = np.arange(mw, dtype=np.int64)

        def bin_save(rec, prefix):
            # bin by the MU target e = pos + lcp0 + 1 (NOT pos): the
            # selection phase's shard-local mu slice must equal the
            # monolithic mu array over its text range bit-for-bit, and a
            # candidate near a shard boundary can END in the next shard
            # (where the selection evaluates and cross-file-skips it)
            e = rec[:, 0] + rec[:, 1] + 1
            sh = np.searchsorted(text_cuts[1:-1], e, side="right")
            for s in range(nsh):
                np.save(os.path.join(workdir, f"{prefix}_{c:04d}_{s:03d}.npy"),
                        rec[sh == s])

        if mode in ("unique", "both"):
            lcp0_w = win("lcp0u", wlo, whi)
            occ_r = occ_unique(ident, gid_w, lcp_w, lcp0_w)[core]
            lcp0 = lcp0_w[core]
            pos = pos_w[core]
            tgt = pos + lcp0 + 1
            keep = tgt <= n
            bin_save(np.stack([pos[keep], lcp0[keep], occ_r[keep]], axis=1),
                     "ut")
        if mode in ("doubly_unique", "both"):
            lcp0_w = win("lcp0d", wlo, whi)
            g2_w = win("g2r", wlo, whi)
            g2w_w = win("g2w", wlo, whi)
            g2_eff = np.where(g2w_w, g2_w, 0)
            occ_d, occ2_d = occ_doubly(ident, gid_w, g2_eff, lcp_w, lcp0_w,
                                       ulmax)
            occ_d, occ2_d = _fix_doubly_exclusion(
                gid_w, g2_eff, lcp_w, lcp0_w, ulmax, occ_d, occ2_d,
                wlo, end_excl)
            pos = pos_w[core]
            lcp0 = lcp0_w[core]
            tgt = pos + lcp0 + 1
            keep = (tgt <= n) & (lcp0 < ulmax)
            bin_save(np.stack([pos[keep], lcp0[keep], occ_d[core][keep],
                               occ2_d[core][keep], g2_eff[core][keep]],
                              axis=1), "dt")


def _fix_doubly_exclusion(gid_w, g2_eff, lcp_w, lcp0_w, ulmax,
                          occ_d, occ2_d, wlo, end_excl):
    """occ_doubly's window call excluded ranks <= top of the WINDOW's
    first run; the global rule is rank <= end_excl (top of the corpus's
    first run).  Zero under-excluded ranks; recompute over-excluded
    ones (only windows overlapping the corpus start can have any)."""
    m = gid_w.shape[0]
    if m == 0:
        return occ_d, occ2_d
    gidx = wlo + np.arange(m)
    must_zero = gidx <= end_excl
    occ_d = np.where(must_zero, 0, occ_d)
    occ2_d = np.where(must_zero, 0, occ2_d)
    w_excl = int(np.nonzero(np.concatenate(
        [gid_w[1:] != gid_w[:-1], [True]]))[0][0])
    over = (~must_zero) & (np.arange(m) <= w_excl) & (lcp0_w <= ulmax)
    if over.any():
        # lift the window's own exclusion with a fake leading run
        gid2 = np.concatenate([[np.int64(-1)], gid_w])
        lcp2 = np.concatenate([[0], lcp_w])
        lcp02 = np.concatenate([[ulmax + 2], lcp0_w])
        g22 = np.concatenate([[0], g2_eff])
        id2 = np.arange(m + 1, dtype=np.int64)
        od, od2 = occ_doubly(id2, gid2, g22, lcp2, lcp02, ulmax)
        occ_d = np.where(over, od[1:], occ_d)
        occ2_d = np.where(over, od2[1:], occ2_d)
    return occ_d, occ2_d
