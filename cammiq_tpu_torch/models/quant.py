"""Quantification solver on torch tensors (float32, on the session's device).

Port of ``cammiq_tpu/models/quant.py:solve_quant`` (257-713): the reference
MIQP (src/query.cpp:1082-1298) as a relaxed box-QP by FISTA projected
gradient + augmented Lagrangian, then the windowed 2^m EXIST-subset sweep
and the exact branch-and-bound with the certified host bound.  The problem
is built on the host by ``build_problem`` and the B&B bound is
``_make_host_bound``: ``prefilter``, ``QuantProblem`` and the bound are
copies of ``cammiq_tpu/models/quant.py`` (41-255).  ``build_problem`` is
held to its source by output, array for array and byte for byte: where
the source passes over every unique entry each sample, it groups the
entries by owner genome once for each index object (``OwnerGroups``) and
then touches only the entries of the genomes that passed the prefilter.

Differences from the JAX version, none of which changes what is solved:
  * the quadratic's gradient is written out; the Hessian-vector product of
    a quadratic is grad(v) - grad(0);
  * a FISTA chunk (``fori_loop`` over the iterations, ``vmap`` over the
    subsets) is ``kernels/quant_fista.py:fista_chunk``: on the card one
    launch of ``csrc/quant_fista.cu`` for the whole batch, on the CPU its
    plain version, a Python loop of torch ops with a leading batch
    dimension;
  * the TOTAL-row knapsack projection finds its multiplier by refining a
    256-point grid three times (2^24 steps, float32 resolution) instead of
    60 sequential bisections: the same bracket, fewer dependent launches;
  * the power-iteration start is drawn from np.random.default_rng(0)
    (jax.random's PRNGKey(0) stream cannot be reproduced), so the step size
    differs in the last digits.
"""

from __future__ import annotations

import dataclasses
import heapq
import sys
import time
import warnings
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import FineParams
from ..device import resolve_device
from ..index.table import FlatIndex
from ..kernels.quant_fista import (e2_rows, fista_chunk, fista_terms,
                                   grad_plain, term_rows)
from ..utils.timing import Stages, span, spanned


def prefilter(
    cnts_u: np.ndarray,
    cnts_d: np.ndarray,
    nus: np.ndarray,
    nds: np.ndarray,
    fine: FineParams,
) -> np.ndarray:
    """exist0 bool [n_species+1] (slot 0 False).  Exact reference logic
    (src/query.cpp:1100-1133): both the unique- and doubly-count tests use
    the *nus* >= easy_to_identify_thres condition."""
    n = cnts_u.shape[0]
    exist = np.ones(n, dtype=bool)
    thr = fine.read_cnt_thres
    alpha = fine.ilp_alpha
    easy = nus >= fine.easy_to_identify_thres

    d1u = cnts_u - thr
    d2u = cnts_u - nus * alpha
    exist &= np.where(easy, (d1u >= 0) & (d2u >= 0), d2u >= 0)
    d1d = cnts_d - thr
    d2d = cnts_d - nds * alpha
    exist &= np.where(easy, (d1d >= 0) & (d2d >= 0), d2d >= 0)
    exist[0] = False
    return exist


@dataclasses.dataclass
class QuantProblem:
    """Flattened QP term arrays (host numpy, species-id indexed)."""

    n: int                      # n_species + 1 (slot 0 unused)
    exist0: np.ndarray          # bool [n]
    # unique terms: uf*(uw*x[ug] - ur)^2
    ug: np.ndarray
    uw: np.ndarray
    ur: np.ndarray
    uf: np.ndarray
    # doubly terms: df*(dw1*x[dg1] + dw2*x[dg2] - dr)^2, owned by `downer`
    downer: np.ndarray
    dg1: np.ndarray
    dg2: np.ndarray
    dw1: np.ndarray
    dw2: np.ndarray
    dr: np.ndarray
    df: np.ndarray
    # bounds and coupled constraints
    lb: np.ndarray              # float [n]
    ub: np.ndarray              # float [n]
    c2_species: np.ndarray      # int [C2] species with a doubly constraint
    c2_rhs: np.ndarray          # float [C2] cnts_d / (1+eps)
    total_g: np.ndarray         # float [n] glength/rl
    total_rhs: float            # (1+eps) * num_reads
    max_cov: float


# OwnerGroups.of's memo: id(index) -> {n: OwnerGroups}; an index's entry
# goes when the index is collected (the columns are read-only after build)
_GROUPS: dict = {}


@dataclasses.dataclass
class OwnerGroups:
    """A unique table's entries grouped by their owner genome
    clip(rid1, 0, n - 1), for one n: ``size`` the entries each genome owns
    (``build_problem``'s map_sp sizes), and ``perm`` the entries by owner,
    each genome's at ``perm[off[g]:off[g + 1]]`` in index order (int32,
    as the table's own row numbers are)."""

    size: np.ndarray            # int64 [n]
    off: np.ndarray             # int64 [n + 1]
    perm: np.ndarray            # int32 [E]

    @classmethod
    def of(cls, index, n: int) -> "OwnerGroups":
        """The grouping of ``index``'s entries, made once for each index
        object and ``n``."""
        memo = _GROUPS.get(id(index))
        if memo is None:
            memo = _GROUPS[id(index)] = {}
            weakref.finalize(index, _GROUPS.pop, id(index), None)
        g = memo.get(n)
        if g is None:
            with span("problem.group_owners", fold=True):
                owner = np.clip(index.rid1, 0, n - 1).astype(
                    np.int16 if n <= np.iinfo(np.int16).max else np.int32)
                size = np.bincount(owner, minlength=n).astype(np.int64)
                # a stable sort of 16-bit keys is NumPy's radix sort
                g = memo[n] = cls(
                    size=size, off=np.concatenate([[0], np.cumsum(size)]),
                    perm=np.argsort(owner, kind="stable").astype(np.int32))
        return g

    def kept(self, exist0: np.ndarray) -> np.ndarray:
        """``np.flatnonzero(exist0[clip(rid1, 0, n - 1)])``: the entries
        whose owner passed the prefilter, in index order."""
        parts = [self.perm[self.off[g]:self.off[g + 1]]
                 for g in np.flatnonzero(exist0)]
        kept = np.concatenate(parts) if parts else self.perm[:0]
        # NumPy sorts 32-bit keys twice as fast as 64-bit ones; the
        # gathers then take intp, which they would each convert to
        return np.sort(kept).astype(np.intp)


@spanned("quant.build_problem")
def build_problem(
    index_u: FlatIndex,
    index_d: Optional[FlatIndex],
    rcount_u: np.ndarray,
    rcount_d: np.ndarray,
    cnts_u: np.ndarray,
    cnts_d: np.ndarray,
    nus: np.ndarray,
    nds: np.ndarray,
    glength: np.ndarray,
    rl: int,
    num_reads: int,
    erate: float,
    fine: FineParams,
) -> QuantProblem:
    """The QP of one sample, in the spans ``problem.prefilter``,
    ``problem.entry_sizes`` (the unique table's ``OwnerGroups``, whose
    first making for an index and n is the folded span
    ``problem.group_owners``, and the doubly table's sizes),
    ``problem.entry_weights`` (the kept unique entries and their
    weights), ``problem.terms`` and ``problem.bounds``.
    Every array is gathered from the kept entries in index order, so each
    value and each ``np.add.at`` is the source's, in its order."""
    n = cnts_u.shape[0]
    with span("problem.prefilter"):
        exist0 = prefilter(cnts_u, cnts_d, nus, nds, fine)
    eps = fine.ilp_epsilon
    has_u = bool(index_u.num_entries)
    has_d = index_d is not None and bool(index_d.num_entries)

    # map_sp sizes: unique entries under rid1; doubly under both rids
    with span("problem.entry_sizes"):
        if has_u:
            groups = OwnerGroups.of(index_u, n)
        size_d = np.zeros(n, np.int64)
        if has_d:
            np.add.at(size_d, np.clip(index_d.rid1.astype(np.int64), 0, n - 1), 1)
            np.add.at(size_d, np.clip(index_d.rid2.astype(np.int64), 0, n - 1), 1)

    def wcov(uc, depth):
        return uc * (rl - depth) / rl * np.power(1.0 - erate, depth)

    # the weights of the prefilter's unique entries; every doubly entry's
    with span("problem.entry_weights"):
        if has_u:
            kept = groups.kept(exist0)
            uw = wcov(index_u.ucount1[kept].astype(np.float64),
                      index_u.length[kept].astype(np.float64))
        if has_d:
            r1 = index_d.rid1.astype(np.int64)
            r2 = index_d.rid2.astype(np.int64)
            w1 = wcov(index_d.ucount1.astype(np.float64),
                      index_d.length.astype(np.float64))
            w2 = wcov(index_d.ucount2.astype(np.float64),
                      index_d.length.astype(np.float64))

    with span("problem.terms"):
        # ---- unique terms (entries of existing species) ----
        if has_u:
            ug = index_u.rid1[kept].astype(np.int64)
            ur = rcount_u[kept].astype(np.float64)
            # size[ug] >= 1 for every realized term (the owner genome
            # owns this very entry), so the max() guard never changes a
            # value; the reference's float division (1000.0/size,
            # src/query.cpp:1155) yields inf only for empty substring
            # lists, which contribute no terms in either implementation
            uf = 1000.0 / np.maximum(groups.size[ug], 1)
        else:
            ug = np.zeros(0, np.int64)
            uw = ur = uf = np.zeros(0, np.float64)

        # ---- doubly terms: one per (existing owner, entry) ----
        downer = dg1 = dg2 = np.zeros(0, np.int64)
        dw1 = dw2 = dr = df = np.zeros(0, np.float64)
        if has_d:
            rr = rcount_d.astype(np.float64)
            blocks = []
            for owner_rid in (r1, r2):
                keep = exist0[np.clip(owner_rid, 0, n - 1)]
                blocks.append(
                    (owner_rid[keep], r1[keep], r2[keep], w1[keep], w2[keep],
                     rr[keep], 1000.0 / np.maximum(size_d[owner_rid[keep]], 1))
                )
            downer = np.concatenate([b[0] for b in blocks])
            dg1 = np.concatenate([b[1] for b in blocks])
            dg2 = np.concatenate([b[2] for b in blocks])
            dw1 = np.concatenate([b[3] for b in blocks])
            dw2 = np.concatenate([b[4] for b in blocks])
            dr = np.concatenate([b[5] for b in blocks])
            df = np.concatenate([b[6] for b in blocks])

    # ---- bounds ----
    with span("problem.bounds"):
        ub = np.where(exist0, fine.max_cov, 0.0)
        # unique coverage constraint collapses to a per-species lower bound
        sumw_u = np.zeros(n, np.float64)
        np.add.at(sumw_u, ug, uw)
        constrained = exist0 & (nus >= fine.easy_to_identify_thres)
        with np.errstate(divide="ignore", invalid="ignore"):
            lb_c = np.where(
                constrained & (sumw_u > 0),
                cnts_u / ((1.0 + eps) * np.maximum(sumw_u, 1e-300)),
                0.0,
            )
        lb = np.minimum(lb_c, ub)

        c2_sp = np.nonzero(constrained)[0]
        c2_rhs = cnts_d[c2_sp].astype(np.float64) / (1.0 + eps)

    return QuantProblem(
        n=n, exist0=exist0,
        ug=ug, uw=uw, ur=ur, uf=uf,
        downer=downer, dg1=dg1, dg2=dg2, dw1=dw1, dw2=dw2, dr=dr, df=df,
        lb=lb, ub=ub,
        c2_species=c2_sp, c2_rhs=c2_rhs,
        total_g=np.asarray(glength, np.float64) / max(rl, 1),
        total_rhs=(1.0 + eps) * num_reads,
        max_cov=fine.max_cov,
    )


def _make_host_bound(prob: QuantProblem):
    """Certified node lower bound for the B&B (host numpy).

    For any multipliers lam >= 0 (doubly-coverage rows, a >= constraint)
    and mu >= 0 (the TOTAL <= row), the Lagrangian
        L(z) = f(z) + lam . (c2_rhs - E2(z)) + mu . (tg.z - total_rhs)
    under-estimates f(z) at every node-feasible z, and by convexity
        L(z) >= L(x) + gL(x) . (z - x)   for all z,
    so  min_{z feasible} f(z) >= L(x) + min_{z in box} gL(x) . (z - x),
    where the box min is closed-form per coordinate.  The bound is VALID
    AT ANY x — an under-converged node solve only loosens it, it can
    never prune the true optimum (the r4 advisor finding: the previous
    prune compared against the FISTA objective value, which upper-bounds
    the relaxed optimum when unconverged).  mu is maximized over a
    log-grid (the bound is concave piecewise-linear in mu, every grid
    point is individually valid)."""
    n = prob.n
    C2 = len(prob.c2_species)
    sp_row = np.full(n, C2, np.int64)
    sp_row[prob.c2_species] = np.arange(C2)
    trow = sp_row[prob.downer] if len(prob.downer) else np.zeros(0, np.int64)
    live = trow < C2

    def bound(x, lam_c2, lbv, ubv):
        x = np.asarray(x, np.float64)
        pu = prob.uw * x[prob.ug] - prob.ur
        pd = prob.dw1 * x[prob.dg1] + prob.dw2 * x[prob.dg2] - prob.dr
        f = float(np.sum(prob.uf * pu * pu) + np.sum(prob.df * pd * pd))
        g = np.zeros(n)
        np.add.at(g, prob.ug, 2.0 * prob.uf * prob.uw * pu)
        np.add.at(g, prob.dg1, 2.0 * prob.df * prob.dw1 * pd)
        np.add.at(g, prob.dg2, 2.0 * prob.df * prob.dw2 * pd)
        const = f
        if C2 > 0 and live.any():
            lam = np.maximum(np.asarray(lam_c2, np.float64), 0.0)
            e2 = np.zeros(C2)
            vals = (prob.dw1 * x[prob.dg1] + prob.dw2 * x[prob.dg2])[live]
            np.add.at(e2, trow[live], vals)
            const += float(np.dot(lam, prob.c2_rhs - e2))
            tm = lam[trow[live]]
            np.add.at(g, prob.dg1[live], -tm * prob.dw1[live])
            np.add.at(g, prob.dg2[live], -tm * prob.dw2[live])
        tgx = float(np.dot(prob.total_g, x))
        mu0 = np.max(np.abs(g)) / (np.max(prob.total_g) + 1e-300)
        best = -np.inf
        for mu in [0.0] + [mu0 * 10.0 ** e for e in range(-6, 3)]:
            gm = g + mu * prob.total_g
            boxmin = np.sum(np.minimum(gm * (lbv - x), gm * (ubv - x)))
            best = max(best, const + mu * (tgx - prob.total_rhs) + boxmin)
        return best

    return bound



@spanned("quant.solve")
def solve_quant(prob: QuantProblem, iters: int = 2000, outer: int = 6,
                penalty: float = 1.0, tol: float = 1e-7,
                time_limit: float = 10800.0, enum_cap: int = 8,
                enum_iters: int = 400, bnb_cap: int = 64,
                bnb_nodes: int = 2048, verbose: bool = False,
                device="cuda") -> Tuple[np.ndarray, np.ndarray, dict]:
    """Returns (exist, cov, info), as ``cammiq_tpu.models.quant.solve_quant``.
    ``info["stage_s"]`` holds the seconds of its stages, the spans
    ``solve.prepare``, ``solve.relax``, ``solve.enum`` and ``solve.bnb``."""
    t0 = time.perf_counter()
    n = prob.n
    if not prob.exist0.any():
        return np.zeros(n, bool), np.zeros(n), {"solve_time": 0.0, "objective": 0.0}
    stages = Stages("solve.", t0)
    stages.begin("prepare")
    dev = resolve_device(device)
    f32 = torch.float32

    def T(a, dtype=f32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # the terms on the device; on the card also folded for the kernel
    terms = fista_terms(prob, dev)
    tg, lb, ub = terms.tg, T(prob.lb), T(prob.ub)
    rhs = terms.rhs
    C2 = terms.C2
    trow_np = term_rows(prob)
    c2_rhs = terms.c2_rhs
    has_c2 = terms.has_c2

    def objective(x):
        pu = terms.uw * x[..., terms.ug] - terms.ur
        pd = (terms.dw1 * x[..., terms.dg1] + terms.dw2 * x[..., terms.dg2]
              - terms.dr)
        return (terms.uf * pu * pu).sum(-1) + (terms.df * pd * pd).sum(-1)

    # Lipschitz estimate via power iteration on the quadratic's Hessian
    g0 = grad_plain(torch.zeros(n, dtype=f32, device=dev), terms)

    def hvp(v):
        return grad_plain(v, terms) - g0

    v = T(np.random.default_rng(0).random(n).astype(np.float32) + 1e-3)
    for _ in range(10):
        hv = hvp(v)
        v = hv / (torch.linalg.vector_norm(hv) + 1e-12)
    L = float(torch.linalg.vector_norm(hvp(v))) + 1e-6
    # scale the AL penalty by the C2 constraint curvature (sparse row norms)
    if has_c2:
        live = trow_np < C2
        keys = np.concatenate([trow_np[live] * n + prob.dg1[live],
                               trow_np[live] * n + prob.dg2[live]])
        vals = np.concatenate([prob.dw1[live], prob.dw2[live]])
        uk, inv = np.unique(keys, return_inverse=True)
        acc = np.zeros(uk.shape[0])
        np.add.at(acc, inv, vals)
        nrm2 = float((acc ** 2).sum())
        rho = penalty * L / max(nrm2, 1e-12)
        step = 1.0 / (L * (1.0 + penalty))
    else:
        rho = 0.0
        step = 1.0 / L

    chunk_iters = max(iters // max(outer, 1), 50)
    chunks = 0

    def fista(x0, lam_c2, lbv, ubv, n_it):
        """One chunk: on the card one launch of csrc/quant_fista.cu."""
        nonlocal chunks
        chunks += 1
        return fista_chunk(x0, lam_c2, lbv, ubv, n_it, terms, step, rho)

    def lam_update(x, lam_c2):
        if not has_c2:
            return lam_c2, torch.zeros(x.shape[:-1] + (C2,), dtype=f32, device=dev)
        viol_c2 = c2_rhs - e2_rows(x, terms)
        return torch.clamp(lam_c2 + rho * viol_c2, min=0.0), viol_c2

    def run_chunk(x0, lam_c2, lbv, ubv):
        x = fista(x0, lam_c2, lbv, ubv, chunk_iters)
        lam_c2, viol_c2 = lam_update(x, lam_c2)
        return x, lam_c2, viol_c2, (x - x0).abs().max()

    c2_rhs_h = np.asarray(prob.c2_rhs, np.float32)

    def run_to_convergence(x, lam_c2, lbv, ubv, max_chunks):
        used = 0
        for _ in range(max_chunks):
            x, lam_c2, vc, dx = run_chunk(x, lam_c2, lbv, ubv)
            used += 1
            feas = True
            if has_c2:
                feas = bool((vc.cpu().numpy()
                             <= tol * np.maximum(c2_rhs_h, 1.0)).all())
            if float(dx) < tol * max(1.0, float(x.abs().max())) and feas:
                break
            if time.perf_counter() - t0 > time_limit:
                break
        return x, lam_c2, used

    # ---- stage 1: relaxed solve ----
    stages.begin("relax")
    x = torch.minimum(torch.maximum(torch.zeros(n, dtype=f32, device=dev), lb), ub)
    lam_c2 = torch.zeros(C2, dtype=f32, device=dev)
    x, lam_c2, chunks_used = run_to_convergence(x, lam_c2, lb, ub, outer)
    xh = x.cpu().numpy()
    stages.begin("enum")

    # ---- stage 2: branch over the (0, 0.01) EXIST hole ----
    forced = prob.exist0 & (prob.lb > 0)
    free = prob.exist0 & ~forced
    free_idx = np.nonzero(free)[0]
    n_free = len(free_idx)
    m = min(n_free, enum_cap)
    S = 1 << m
    masks = (np.arange(S)[:, None] >> np.arange(m)[None, :]) & 1  # [S, m]
    sel = masks.astype(bool)
    rows = np.repeat(np.arange(S), max(m, 1)).reshape(S, max(m, 1))

    def subset_bounds(enum_idx, decisions):
        """[S, n] bounds: forced genomes in, non-window free genomes fixed
        per `decisions`, window genomes swept over all 2**m subsets."""
        base_lb = np.where(forced, np.maximum(prob.lb, 0.01), 0.0)
        base_ub = np.where(forced, prob.ub, 0.0)
        fixed_sel = free_idx[decisions & ~np.isin(free_idx, enum_idx)]
        base_lb[fixed_sel] = 0.01
        base_ub[fixed_sel] = prob.ub[fixed_sel]
        lb_s = np.broadcast_to(base_lb, (S, n)).copy()
        ub_s = np.broadcast_to(base_ub, (S, n)).copy()
        if m:
            cols = np.broadcast_to(enum_idx, (S, m))[sel]
            lb_s[rows[sel], cols] = 0.01
            ub_s[rows[sel], cols] = np.broadcast_to(prob.ub[enum_idx], (S, m))[sel]
        return lb_s, ub_s

    def penalty_score(xs, knee):
        """objective + exact penalty on relative constraint violation
        beyond `knee`."""
        rv_tot = torch.clamp((xs * tg).sum(-1) - rhs, min=0.0) / max(rhs, 1.0)
        pen = 1e12 * torch.clamp(rv_tot - knee, min=0.0)
        if has_c2:
            rv_c2 = torch.clamp(c2_rhs - e2_rows(xs, terms), min=0.0) / torch.clamp(
                c2_rhs, min=1.0)
            pen = pen + 1e12 * torch.clamp(rv_c2 - knee, min=0.0).sum(-1)
        return objective(xs) + pen

    def solve_subsets(lbv, ubv, x0, lc0):
        xs = torch.minimum(torch.maximum(x0.expand_as(lbv), lbv), ubv)
        lc = lc0.expand(lbv.shape[0], C2)
        for _ in range(2):  # two AL rounds per subset
            xs = fista(xs, lc, lbv, ubv, max(enum_iters // 2, 1))
            lc, _ = lam_update(xs, lc)
        # loose knee: rank near-feasible subsets by objective; the exact
        # knee is applied after the polish below
        return penalty_score(xs, 1e-3), xs

    decisions = xh[free_idx] >= 0.005 if n_free else np.zeros(0, bool)
    seen = np.zeros(n_free, bool)
    max_rounds = 1 if n_free <= enum_cap else 2 * -(-n_free // max(m, 1)) + 2
    if verbose and n_free > enum_cap:
        print(f"[quant] {n_free} free candidates exceed enum_cap={enum_cap}; "
              f"iterating enumeration windows (<= {max_rounds} rounds)",
              file=sys.stderr)

    best_x = x
    best_ub_full = np.where(forced, prob.ub, 0.0)
    rounds_used = 0
    stopped_by = "sweep" if n_free <= enum_cap else "round_budget"
    for _round in range(max_rounds):
        rounds_used += 1
        amb = np.abs(xh[free_idx] - 0.005)
        win = np.lexsort((amb, seen))[:m]
        enum_idx = free_idx[win]
        lb_s, ub_s = subset_bounds(enum_idx, decisions)
        scores, xs_all = solve_subsets(T(lb_s), T(ub_s), x, lam_c2)
        scores = scores.cpu().numpy()

        # ---- stage 3: polish the top candidates, rescore with the tight
        # feasibility knee, keep the best ----
        cand = np.argsort(scores)[:min(S, 4)]
        best_score = np.inf
        best = int(cand[0])
        for s in cand:
            lbj, ubj = T(lb_s[s]), T(ub_s[s])
            xb = torch.minimum(torch.maximum(xs_all[int(s)], lbj), ubj)
            xb, _, _ = run_to_convergence(xb, lam_c2, lbj, ubj,
                                          max(outer // 2, 1))
            sc = float(penalty_score(xb, 1e-6))
            if sc < best_score:
                best_score, best, best_x = sc, int(s), xb
        xh = best_x.cpu().numpy()
        best_ub_full = ub_s[best]

        new_dec = ((best >> np.arange(m)) & 1).astype(bool) if m else np.zeros(0, bool)
        changed = bool((decisions[win] != new_dec).any())
        decisions[win] = new_dec
        seen[win] = True
        if not changed and seen.all():
            if n_free > enum_cap:
                stopped_by = "stability"
            break
        if time.perf_counter() - t0 > time_limit:
            stopped_by = "time_limit"
            break

    stages.begin("bnb")

    # ---- stage 2b: exact best-first B&B with the certified bound ----
    bnb_complete = False
    nodes = 0
    bound_s = 0.0
    if enum_cap < n_free <= bnb_cap and stopped_by != "time_limit":
        host_bound = _make_host_bound(prob)
        incumbent = float(penalty_score(best_x, 1e-6))
        base_lb = np.where(forced, np.maximum(prob.lb, 0.01), 0.0)
        base_ub_f = np.where(forced, prob.ub, 0.0)
        tie = 0
        heap = [(-np.inf, tie, np.full(n_free, -1, np.int8), xh)]
        bnb_complete = True
        while heap:
            pbound, _, st, xwarm = heapq.heappop(heap)
            margin = 1e-9 * (1.0 + abs(incumbent))
            if pbound >= incumbent - margin:
                continue
            if nodes >= bnb_nodes or time.perf_counter() - t0 > time_limit:
                bnb_complete = False
                stopped_by = ("bnb_node_cap" if nodes >= bnb_nodes
                              else "time_limit")
                break
            nodes += 1
            lbv = base_lb.copy()
            ubv = base_ub_f.copy()
            inn = free_idx[st == 1]
            und = free_idx[st == -1]
            lbv[inn] = 0.01
            ubv[inn] = prob.ub[inn]
            ubv[und] = prob.ub[und]   # hole relaxed: lb stays 0
            lbj, ubj = T(lbv), T(ubv)
            xr, lam_r, _ = run_to_convergence(
                torch.minimum(torch.maximum(T(xwarm), lbj), ubj),
                torch.zeros(C2, dtype=f32, device=dev), lbj, ubj,
                max(outer // 2, 2))
            xrn = xr.cpu().numpy()
            tb = time.perf_counter()
            cert = host_bound(xrn, lam_r.cpu().numpy(), lbv, ubv)
            bound_s += time.perf_counter() - tb
            if cert >= incumbent - margin:
                continue
            sc = float(penalty_score(xr, 1e-6))
            uv = xrn[und]
            hole = (uv > 1e-9) & (uv < 0.01 - 1e-9)
            if not hole.any():
                if sc < incumbent:
                    incumbent = sc
                    best_x = xr
                    best_ub_full = np.where(xrn >= 0.009, ubv, 0.0)
                continue
            ji = int(np.argmax(np.minimum(uv, 0.01 - uv) * hole))
            j = int(np.nonzero(free_idx == und[ji])[0][0])
            st_in = st.copy()
            st_in[j] = 1
            st_out = st.copy()
            st_out[j] = 0
            first, second = ((st_in, st_out) if uv[ji] >= 0.005
                             else (st_out, st_in))
            for child in (first, second):
                tie += 1
                heapq.heappush(heap, (cert, tie, child, xrn))
        if bnb_complete:
            stopped_by = "bnb"
        xh = best_x.cpu().numpy()
        if verbose:
            print(f"[quant] B&B: {nodes} nodes, complete={bnb_complete}, "
                  f"incumbent={incumbent:.6g}", file=sys.stderr)

    stages.end()
    exist = best_ub_full > 0
    cov = np.where(exist, np.clip(xh, 0.01, None), 0.0)
    cov = np.minimum(cov, prob.ub)

    obj = float(objective(T(cov)))
    info = {
        "solve_time": time.perf_counter() - t0,
        "objective": obj,
        "lipschitz": L,
        "num_candidates": int(prob.exist0.sum()),
        "free_candidates": n_free,
        "enum_size": S,
        "enum_rounds": rounds_used,
        "chunks_used": chunks_used,
        "exhaustive": n_free <= enum_cap or bnb_complete,
        "stopped_by": stopped_by,
        "c2_rows": C2,
        "fista_chunks": chunks,
        "bnb_nodes": nodes,
        "bound_s": bound_s,
        "stage_s": stages.seconds,
    }
    if not info["exhaustive"]:
        warnings.warn(
            f"quant: {n_free} free EXIST candidates exceed enum_cap="
            f"{enum_cap} and the exact B&B did not complete (stopped by "
            f"{stopped_by}); the selection is locally optimal but not "
            f"proven exact (raise --ilp_enum_cap or bnb_nodes)")
    if verbose:
        print(f"[quant] candidates={info['num_candidates']} forced="
              f"{int(forced.sum())} free={n_free} enum_subsets={S}x"
              f"{rounds_used} relax_chunks={chunks_used}x{chunk_iters} "
              f"L={L:.4g} C2_rows={C2}", file=sys.stderr)
        print(f"[quant] winner objective={obj:.6g} "
              f"selected={np.nonzero(exist)[0].tolist()} "
              f"time={info['solve_time']*1e3:.0f} ms", file=sys.stderr)
    return exist, cov, info
