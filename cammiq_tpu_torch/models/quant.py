"""Quantification solver on torch tensors (float32, on the session's device).

Port of ``cammiq_tpu/models/quant.py:solve_quant`` (257-713): the reference
MIQP (src/query.cpp:1082-1298) as a relaxed box-QP by FISTA projected
gradient + augmented Lagrangian, then the windowed 2^m EXIST-subset sweep
and the exact branch-and-bound with the certified host bound.  The problem
is built on the host by ``cammiq_tpu.models.quant.build_problem`` and the
B&B bound is ``_make_host_bound``, both imported unchanged.

Differences from the JAX version, none of which changes what is solved:
  * the quadratic's gradient is written out; the Hessian-vector product of
    a quadratic is grad(v) - grad(0);
  * ``fori_loop`` becomes a Python loop and ``vmap`` over subsets a leading
    batch dimension;
  * the TOTAL-row knapsack projection finds its multiplier by refining a
    256-point grid three times (2^24 steps, float32 resolution) instead of
    60 sequential bisections: the same bracket, fewer dependent launches;
  * the power-iteration start is drawn from np.random.default_rng(0)
    (jax.random's PRNGKey(0) stream cannot be reproduced), so the step size
    differs in the last digits.
"""

from __future__ import annotations

import heapq
import sys
import time
import warnings
from typing import Tuple

import numpy as np
import torch

from cammiq_tpu.models.quant import QuantProblem, _make_host_bound

from ..device import resolve_device

_GRID = 256
_GRID_ROUNDS = 3


def solve_quant(prob: QuantProblem, iters: int = 2000, outer: int = 6,
                penalty: float = 1.0, tol: float = 1e-7,
                time_limit: float = 10800.0, enum_cap: int = 8,
                enum_iters: int = 400, bnb_cap: int = 64,
                bnb_nodes: int = 2048, verbose: bool = False,
                device="cuda") -> Tuple[np.ndarray, np.ndarray, dict]:
    """Returns (exist, cov, info), as ``cammiq_tpu.models.quant.solve_quant``."""
    t0 = time.perf_counter()
    n = prob.n
    if not prob.exist0.any():
        return np.zeros(n, bool), np.zeros(n), {"solve_time": 0.0, "objective": 0.0}
    dev = resolve_device(device)
    f32 = torch.float32

    def T(a, dtype=f32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    ug, dg1, dg2 = (T(a, torch.int64) for a in (prob.ug, prob.dg1, prob.dg2))
    uw, ur, uf = T(prob.uw), T(prob.ur), T(prob.uf)
    dw1, dw2, dr, df = T(prob.dw1), T(prob.dw2), T(prob.dr), T(prob.df)
    tg, lb, ub = T(prob.total_g), T(prob.lb), T(prob.ub)
    rhs = float(prob.total_rhs)

    # doubly coverage rows: term t belongs to row sp_row[downer[t]]
    C2 = len(prob.c2_species)
    sp_row = np.full(prob.n, C2, np.int64)   # C2 = dropped row
    sp_row[prob.c2_species] = np.arange(C2)
    trow_np = sp_row[prob.downer] if len(prob.downer) else np.zeros(0, np.int64)
    trow = T(trow_np, torch.int64)
    # the JAX version reads mults[trow] with XLA's clamped gather, so a
    # dropped row (index C2) reads row C2-1; kept for identical iterates
    trow_read = trow.clamp(max=max(C2 - 1, 0))
    c2_rhs = T(prob.c2_rhs)
    has_c2 = C2 > 0 and len(prob.downer) > 0

    def residuals(x):
        pu = uw * x[..., ug] - ur
        pd = dw1 * x[..., dg1] + dw2 * x[..., dg2] - dr
        return pu, pd

    def objective(x):
        pu, pd = residuals(x)
        return (uf * pu * pu).sum(-1) + (df * pd * pd).sum(-1)

    def grad(x):
        pu, pd = residuals(x)
        g = torch.zeros_like(x)
        g.index_add_(-1, ug, 2.0 * uf * uw * pu)
        g.index_add_(-1, dg1, 2.0 * df * dw1 * pd)
        g.index_add_(-1, dg2, 2.0 * df * dw2 * pd)
        return g

    def e2_rows(x):
        vals = dw1 * x[..., dg1] + dw2 * x[..., dg2]
        out = torch.zeros(x.shape[:-1] + (C2 + 1,), dtype=f32, device=dev)
        return out.index_add_(-1, trow, vals)[..., :C2]

    def al_grad(x, lam_c2, rho):
        g = grad(x)
        if has_c2:
            mults = torch.clamp(lam_c2 + rho * (c2_rhs - e2_rows(x)), min=0.0)
            tm = mults[..., trow_read]
            g.index_add_(-1, dg1, -tm * dw1)
            g.index_add_(-1, dg2, -tm * dw2)
        return g

    def project(y, lbv, ubv):
        """Exact projection onto the box intersected with {tg.x <= rhs}:
        f(mu) = tg . clip(y - mu tg) - rhs is nonincreasing; the result is
        the projection at the smallest grid mu with f(mu) <= 0."""
        x = torch.minimum(torch.maximum(y, lbv), ubv)
        viol = (x * tg).sum(-1) - rhs
        pos = tg > 0
        hi = torch.where(pos, (y - lbv) / torch.where(pos, tg, 1.0), 0.0)
        hi = torch.clamp(hi.amax(-1), min=1.0)
        a = torch.zeros_like(hi)
        b = hi
        frac = torch.arange(1, _GRID + 1, dtype=f32, device=dev) / _GRID
        y_, lb_, ub_ = y[..., None, :], lbv[..., None, :], ubv[..., None, :]
        for _ in range(_GRID_ROUNDS):
            mus = a[..., None] + (b - a)[..., None] * frac       # [..., G]
            xs = torch.minimum(torch.maximum(y_ - mus[..., None] * tg, lb_), ub_)
            feas = (xs * tg).sum(-1) - rhs <= 0
            k = torch.argmax(feas.to(torch.uint8), dim=-1, keepdim=True)
            any_f = feas.any(-1)
            nb = torch.gather(mus, -1, k)[..., 0]
            na = torch.where(k[..., 0] > 0,
                             torch.gather(mus, -1, (k - 1).clamp(min=0))[..., 0], a)
            a = torch.where(any_f, na, b)
            b = torch.where(any_f, nb, b)
        xb = torch.minimum(torch.maximum(y - b[..., None] * tg, lbv), ubv)
        return torch.where((viol > 0)[..., None], xb, x)

    # Lipschitz estimate via power iteration on the quadratic's Hessian
    g0 = grad(torch.zeros(n, dtype=f32, device=dev))

    def hvp(v):
        return grad(v) - g0

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

    def fista(x0, lam_c2, lbv, ubv, n_it):
        x, y = x0, x0
        t = torch.ones(x0.shape[:-1], dtype=f32, device=dev)
        for _ in range(n_it):
            g = al_grad(y, lam_c2, rho)
            xn = project(y - step * g, lbv, ubv)
            # gradient-based adaptive restart (O'Donoghue & Candes)
            restart = (g * (xn - x)).sum(-1) > 0
            tn = torch.where(restart, 1.0, 0.5 * (1 + torch.sqrt(1 + 4 * t * t)))
            yn = project(xn + ((t - 1) / tn)[..., None] * (xn - x), lbv, ubv)
            y = torch.where(restart[..., None], xn, yn)
            x, t = xn, tn
        return x

    def lam_update(x, lam_c2):
        if not has_c2:
            return lam_c2, torch.zeros(x.shape[:-1] + (C2,), dtype=f32, device=dev)
        viol_c2 = c2_rhs - e2_rows(x)
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
    x = torch.minimum(torch.maximum(torch.zeros(n, dtype=f32, device=dev), lb), ub)
    lam_c2 = torch.zeros(C2, dtype=f32, device=dev)
    x, lam_c2, chunks_used = run_to_convergence(x, lam_c2, lb, ub, outer)
    xh = x.cpu().numpy()

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
            rv_c2 = torch.clamp(c2_rhs - e2_rows(xs), min=0.0) / torch.clamp(
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

    # ---- stage 2b: exact best-first B&B with the certified bound ----
    bnb_complete = False
    nodes = 0
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
            cert = host_bound(xrn, lam_r.cpu().numpy(), lbv, ubv)
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
