"""Quantification's answer worked out plainly: CAMMiQ's MIQP
(``src/query.cpp:1082-1298``) by branch and bound.

The model, from the reference's CPLEX program, over the genomes the
prefilter keeps (``answers.quant_candidates``):

- a unique entry of a candidate genome g is a term
  ``f (w c_g - r)^2``, a doubly-unique entry one term for each candidate
  among its two genomes, ``f (w1 c_g1 + w2 c_g2 - r)^2``; ``r`` is the
  entry's read count, ``w = ucount (L - length) / L (1 - erate)^length``
  (L the mean read length), and ``f = 1000 /`` the number of entries the
  term's owner has in that table;
- a chosen genome's coverage lies in [0.01, max_cov], any other's is 0;
- a genome whose unique L-mer count reaches ``easy_to_identify_thres``
  covers its reads: ``(1 + eps)`` times its unique terms' weights times
  the coverage is at least its unique read count, and likewise for its
  doubly-unique terms and count;
- the coverages times genome length over L sum to at most
  ``(1 + eps)`` times the reads.

The search: an easy genome with unique reads is chosen in every feasible
assignment (its unique row holds its coverage alone).  Over the others, a
node fixes some genomes in or out and relaxes the rest to coverages in
[0, max_cov]; the objective is a sum of squares, so the relaxation, solved
with scipy's SLSQP, bounds every assignment below the node.  A node whose
relaxation is no better than the best assignment found is dropped; one
whose relaxed coverages are each 0 or at least 0.01 is an assignment; any
other branches on its free genome nearest 0.005, and one whose relaxation
SLSQP leaves infeasible branches on its first free genome, unbounded.  Each assignment's own QP
is then solved with its chosen coverages in [0.01, max_cov], and the
feasible one with the least objective (the fewest genomes on a tie) is the
answer.  The abundances are the chosen coverages over their sum.  The
entries' payloads come from the judged index; the counts are the
reference's own.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize


def solve(payload_u: dict, payload_d: dict, rcount_u, rcount_d, cnts_u, cnts_d,
          cand, easy, glength, rl: int, num_reads: int, erate: float,
          eps=0.01, max_cov=100.0):
    """(exist bool [n], abundance [n], objective) of the optimum; with no
    feasible assignment, nothing exists and the objective is inf."""
    n = len(cnts_u)
    surv = np.nonzero(cand)[0]
    if not surv.size:
        return np.zeros(n, bool), np.zeros(n), 0.0
    qp, forced = model(payload_u, payload_d, rcount_u, rcount_d, cnts_u, cnts_d,
                       cand, easy, glength, rl, num_reads, erate, eps, max_cov)
    sel, c, val = branch_and_bound(qp, forced)
    exist = np.zeros(n, bool)
    exist[surv] = sel
    ab = np.zeros(n)
    if sel.any():
        ab[surv] = c / c.sum()
    return exist, ab, val


def model(payload_u: dict, payload_d: dict, rcount_u, rcount_d, cnts_u, cnts_d,
          cand, easy, glength, rl: int, num_reads: int, erate: float,
          eps=0.01, max_cov=100.0):
    """(qp, forced) over the k candidates in id order: ``qp(lo)`` gives
    (coverages [k], objective, feasible) of the QP whose coverage i lies
    in [lo[i], max_cov], NaN holding it at 0; ``forced`` bool [k] marks the
    genomes every feasible assignment chooses."""
    n = len(cnts_u)
    surv = np.nonzero(cand)[0]
    pos = {int(g): i for i, g in enumerate(surv)}
    k = surv.size

    def wcov(uc, length):
        return uc * (rl - length) / rl * (1.0 - erate) ** length

    # quadratic form over the candidates: obj = z'Qz - 2 b'z + const
    Q = np.zeros((k, k))
    b = np.zeros(k)
    const = 0.0
    a_u = np.zeros(k)       # unique coverage row of each candidate (its own)
    a_d = np.zeros((k, k))  # doubly coverage row of each candidate
    g = payload_u["rid1"].astype(np.int64)
    size_u = np.bincount(g, minlength=n)
    keep = cand[g]
    w = wcov(payload_u["ucount1"][keep].astype(np.float64),
             payload_u["length"][keep].astype(np.float64))
    r = np.asarray(rcount_u, np.float64)[keep]
    gi = np.searchsorted(surv, g[keep])
    f = 1000.0 / size_u[g[keep]]
    np.add.at(Q, (gi, gi), f * w * w)
    np.add.at(b, gi, f * w * r)
    const += float((f * r * r).sum())
    np.add.at(a_u, gi, w)
    g1 = payload_d["rid1"].astype(np.int64)
    g2 = payload_d["rid2"].astype(np.int64)
    size_d = np.bincount(g1, minlength=n) + np.bincount(g2, minlength=n)
    w1 = wcov(payload_d["ucount1"].astype(np.float64), payload_d["length"].astype(np.float64))
    w2 = wcov(payload_d["ucount2"].astype(np.float64), payload_d["length"].astype(np.float64))
    rd = np.asarray(rcount_d, np.float64)
    for owner in (g1, g2):
        for e in np.nonzero(cand[owner])[0]:
            f = 1000.0 / size_d[owner[e]]
            # coordinates of g1, g2 among the candidates (a non-candidate's
            # coverage is 0 and drops out)
            terms = [(pos[int(x)], wx) for x, wx in ((g1[e], w1[e]), (g2[e], w2[e]))
                     if int(x) in pos]
            for i, wi in terms:
                b[i] += f * wi * rd[e]
                for j, wj in terms:
                    Q[i, j] += f * wi * wj
            const += f * rd[e] ** 2
            o = pos[int(owner[e])]
            for i, wi in terms:
                a_d[o, i] += wi
    easy = np.asarray(easy, bool)[surv]
    rows = [((1.0 + eps) * np.eye(k)[i] * a_u[i], float(cnts_u[surv[i]]))
            for i in range(k) if easy[i]]
    rows += [((1.0 + eps) * a_d[i], float(cnts_d[surv[i]]))
             for i in range(k) if easy[i]]
    tot_a = np.asarray(glength, np.float64)[surv] / rl
    tot_rhs = (1.0 + eps) * num_reads

    def obj(z):
        return float(z @ Q @ z - 2 * b @ z + const)

    def qp(lo):
        idx = np.nonzero(~np.isnan(lo))[0]
        if any(rhs > 1e-6 and not (np.abs(a[idx]) > 0).any() for a, rhs in rows):
            return None, np.inf, False
        if not idx.size:
            return np.zeros(k), obj(np.zeros(k)), True

        def full(z):
            c = np.zeros(k)
            c[idx] = z
            return c

        cons = [{"type": "ineq", "fun": (lambda z, a=a, rhs=rhs: a[idx] @ z - rhs),
                 "jac": (lambda z, a=a: a[idx])} for a, rhs in rows]
        cons.append({"type": "ineq", "fun": lambda z: tot_rhs - tot_a[idx] @ z,
                     "jac": lambda z: -tot_a[idx]})
        # SLSQP on the objective scaled to about 1 at the start
        z0 = np.ones(idx.size)
        scale = max(1.0, abs(obj(full(z0))))
        res = minimize(lambda z: obj(full(z)) / scale, z0,
                       jac=lambda z: 2 * (Q @ full(z) - b)[idx] / scale,
                       bounds=[(lo[i], max_cov) for i in idx], constraints=cons,
                       method="SLSQP", options={"maxiter": 300, "ftol": 1e-15})
        c = full(res.x)
        return c, obj(c), feasible(c)

    def feasible(c):
        return bool(tot_a @ c <= tot_rhs * (1 + 1e-6)
                    and all(a @ c >= rhs - 1e-6 * max(1.0, abs(rhs))
                            for a, rhs in rows))

    forced = easy & (np.asarray(cnts_u, np.float64)[surv] > 1e-6) & (a_u > 0)
    qp.objective, qp.feasible = obj, feasible
    return qp, forced


def branch_and_bound(qp, forced) -> tuple:
    """(chosen bool [k], coverages [k], objective) of the best feasible
    assignment (objective inf and nothing chosen where none is)."""
    k = forced.shape[0]
    best = [np.zeros(k, bool), np.zeros(k), np.inf]
    # a node: lower ends, 0.01 for a genome fixed in, 0 for a free one,
    # NaN for one fixed out
    stack = [np.where(forced, 0.01, 0.0)]
    while stack:
        lo = stack.pop()
        c, val, ok = qp(lo)
        free = np.nonzero(lo == 0.0)[0]
        if not ok and c is not None and free.size:
            # no bound where SLSQP ends infeasible: branch on a free genome
            frac = free[:1]
        elif not ok or val >= best[2] - 1e-9 * max(1.0, abs(best[2])):
            continue
        else:
            frac = free[(c[free] > 1e-9) & (c[free] < 0.01 - 1e-9)]
        if frac.size:
            i = frac[np.argmin(np.abs(c[frac] - 0.005))] if ok else frac[0]
            out, inn = lo.copy(), lo.copy()
            out[i], inn[i] = np.nan, 0.01
            stack += [inn, out]         # out is searched first
            continue
        sel = ~np.isnan(lo) & ((lo > 0) | (c >= 0.01 - 1e-9))
        c, val, ok = qp(np.where(sel, 0.01, np.nan))
        if ok and (val < best[2] - 1e-12
                   or (val <= best[2] + 1e-12 and sel.sum() < best[0].sum())):
            best = [sel, c, val]
    return tuple(best)
