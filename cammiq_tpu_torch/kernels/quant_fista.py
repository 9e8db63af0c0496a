"""The quantification solver's FISTA chunk: plain PyTorch version + CUDA
kernel wrapper.

Replaces the body of ``cammiq_tpu/models/quant.py:solve_quant``'s
``fista`` (412-428: ``jax.lax.fori_loop`` over ``al_grad`` and two calls
of ``project``), run by ``vmap`` over subsets in ``solve_subsets``
(511-523): XLA work with no Pallas original.  One call runs ``n_it``
iterations of projected FISTA with the O'Donoghue-Candes restart for a
batch of S problems that share their terms and differ in their start,
multipliers and bounds:

    g   = grad f(y) - sum_t max(lam + rho (c2_rhs - E2 y), 0)[row(t)] dE2_t
    x'  = P(y - step g)                      P: box n {tg . x <= rhs}
    y'  = x' if g . (x' - x) > 0 else P(x' + (t - 1) / t' (x' - x))

The plain version is the solver's own float32 torch code, term by term,
and is the kernel's oracle.  The kernel (``csrc/quant_fista.cu``) takes the
terms folded once a solve into sparse matrices (``fold_terms``): the
objective is a quadratic, so its gradient is H y - hb; the doubly rows'
sums are M y; their multipliers reach the gradient through R.  An
iteration is then O(n + nnz) work instead of O(T).  The projection's grid
is the plain version's: three rounds of 256 points, the first feasible
one taken.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .build import F32, I32, VP, CudaKernel, check_tensor, stream_ptr

GRID = 256
GRID_ROUNDS = 3

KERNEL = CudaKernel("cammiq_quant_fista",
                    [VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP,
                     VP, VP, I32, I32, I32, I32, I32, F32, F32, F32, VP, VP,
                     VP, VP])


@dataclasses.dataclass
class FistaTerms:
    """A quant problem's terms on one device (float32).  ``folded`` holds
    the kernel's sparse matrices, made on a CUDA device only."""

    n: int
    C2: int
    has_c2: bool
    rhs: float                  # total_rhs, the TOTAL row's bound
    ug: torch.Tensor
    uw: torch.Tensor
    ur: torch.Tensor
    uf: torch.Tensor
    dg1: torch.Tensor
    dg2: torch.Tensor
    dw1: torch.Tensor
    dw2: torch.Tensor
    dr: torch.Tensor
    df: torch.Tensor
    tg: torch.Tensor
    trow: torch.Tensor          # doubly term -> its C2 row (C2: no row)
    trow_read: torch.Tensor     # the row whose multiplier the term reads
    c2_rhs: torch.Tensor
    folded: Optional[dict] = None


def term_rows(prob) -> np.ndarray:
    """Each doubly term's C2 row, C2 where its owner has none."""
    C2 = len(prob.c2_species)
    sp_row = np.full(prob.n, C2, np.int64)
    sp_row[prob.c2_species] = np.arange(C2)
    return sp_row[prob.downer] if len(prob.downer) else np.zeros(0, np.int64)


def fista_terms(prob, device) -> FistaTerms:
    """``prob`` (a ``models.quant.QuantProblem``) on ``device``."""
    dev = torch.device(device)

    def T(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    C2 = len(prob.c2_species)
    trow = term_rows(prob)
    # the JAX version reads mults[trow] with XLA's clamped gather, so a
    # dropped row (index C2) reads row C2-1; kept for identical iterates
    trow_read = np.minimum(trow, max(C2 - 1, 0))
    terms = FistaTerms(
        n=prob.n, C2=C2, has_c2=C2 > 0 and len(prob.downer) > 0,
        rhs=float(prob.total_rhs),
        ug=T(prob.ug, torch.int64), uw=T(prob.uw), ur=T(prob.ur), uf=T(prob.uf),
        dg1=T(prob.dg1, torch.int64), dg2=T(prob.dg2, torch.int64),
        dw1=T(prob.dw1), dw2=T(prob.dw2), dr=T(prob.dr), df=T(prob.df),
        tg=T(prob.total_g), trow=T(trow, torch.int64),
        trow_read=T(trow_read, torch.int64), c2_rhs=T(prob.c2_rhs))
    if dev.type == "cuda":
        terms.folded = {k: torch.as_tensor(v, device=dev)
                        for k, v in fold_terms(prob, trow, trow_read).items()}
    return terms


def _csr(rows, cols, vals, nrows: int, ncols: int, dtype=np.float64):
    """(ptr int32 [nrows + 1], col int32, val ``dtype``) of the sum of
    ``vals`` at (rows, cols), summed in float64."""
    key = rows.astype(np.int64) * ncols + cols.astype(np.int64)
    uk, inv = np.unique(key, return_inverse=True)
    acc = np.bincount(inv.reshape(-1), weights=vals, minlength=uk.shape[0])
    ptr = np.zeros(nrows + 1, np.int64)
    np.cumsum(np.bincount(uk // ncols, minlength=nrows), out=ptr[1:])
    return (ptr.astype(np.int32), (uk % ncols).astype(np.int32),
            acc.astype(dtype))


def fold_terms(prob, trow: np.ndarray, trow_read: np.ndarray) -> dict:
    """The kernel's form of the terms, one pass over them a solve:
    grad f(x) = H x - hb; the C2 rows' sums E2 x = M x; the multipliers
    reach the gradient as R mults (R [n, C2], by ``trow_read``: a term
    with no row still reads row C2-1, as the plain version does, while M
    drops it).  H, hb and M stay float64 (the kernel sums in float64: H x
    and hb cancel near the optimum); R is float32."""
    n, C2 = prob.n, len(prob.c2_species)
    ug, dg1, dg2 = prob.ug, prob.dg1, prob.dg2
    uw, ur, uf = prob.uw, prob.ur, prob.uf
    dw1, dw2, dr, df = prob.dw1, prob.dw2, prob.dr, prob.df
    h_ptr, h_col, h_val = _csr(
        np.concatenate([ug, dg1, dg1, dg2, dg2]),
        np.concatenate([ug, dg1, dg2, dg1, dg2]),
        np.concatenate([2 * uf * uw * uw, 2 * df * dw1 * dw1,
                        2 * df * dw1 * dw2, 2 * df * dw2 * dw1,
                        2 * df * dw2 * dw2]), n, n)
    hb = (np.bincount(ug, 2 * uf * uw * ur, minlength=n)
          + np.bincount(dg1, 2 * df * dw1 * dr, minlength=n)
          + np.bincount(dg2, 2 * df * dw2 * dr, minlength=n))
    if C2 > 0 and len(prob.downer) > 0:
        live = trow < C2
        m = _csr(np.concatenate([trow[live], trow[live]]),
                 np.concatenate([dg1[live], dg2[live]]),
                 np.concatenate([dw1[live], dw2[live]]), C2, n)
        r = _csr(np.concatenate([dg1, dg2]),
                 np.concatenate([trow_read, trow_read]),
                 np.concatenate([dw1, dw2]), n, C2, np.float32)
    else:
        m = (np.zeros(1, np.int32), np.zeros(0, np.int32), np.zeros(0))
        r = (np.zeros(n + 1, np.int32), np.zeros(0, np.int32),
             np.zeros(0, np.float32))
    return {"h_ptr": h_ptr, "h_col": h_col, "h_val": h_val,
            "hb": hb.astype(np.float64), "m_ptr": m[0], "m_col": m[1],
            "m_val": m[2], "r_ptr": r[0], "r_row": r[1], "r_val": r[2]}


# ---- the plain version: the solver's float32 torch code, term by term

def grad_plain(x: torch.Tensor, p: FistaTerms) -> torch.Tensor:
    """Gradient of the quadratic objective at x [..., n]."""
    pu = p.uw * x[..., p.ug] - p.ur
    pd = p.dw1 * x[..., p.dg1] + p.dw2 * x[..., p.dg2] - p.dr
    g = torch.zeros_like(x)
    g.index_add_(-1, p.ug, 2.0 * p.uf * p.uw * pu)
    g.index_add_(-1, p.dg1, 2.0 * p.df * p.dw1 * pd)
    g.index_add_(-1, p.dg2, 2.0 * p.df * p.dw2 * pd)
    return g


def e2_rows(x: torch.Tensor, p: FistaTerms) -> torch.Tensor:
    """The C2 rows' doubly coverage sums at x [..., n] -> [..., C2]."""
    vals = p.dw1 * x[..., p.dg1] + p.dw2 * x[..., p.dg2]
    out = torch.zeros(x.shape[:-1] + (p.C2 + 1,), dtype=x.dtype, device=x.device)
    return out.index_add_(-1, p.trow, vals)[..., :p.C2]


def _al_grad(x, lam_c2, rho, p: FistaTerms):
    g = grad_plain(x, p)
    if p.has_c2:
        mults = torch.clamp(lam_c2 + rho * (p.c2_rhs - e2_rows(x, p)), min=0.0)
        tm = mults[..., p.trow_read]
        g.index_add_(-1, p.dg1, -tm * p.dw1)
        g.index_add_(-1, p.dg2, -tm * p.dw2)
    return g


def _project(y, lbv, ubv, p: FistaTerms):
    """Exact projection onto the box intersected with {tg.x <= rhs}:
    f(mu) = tg . clip(y - mu tg) - rhs is nonincreasing; the result is
    the projection at the smallest grid mu with f(mu) <= 0."""
    tg, rhs = p.tg, p.rhs
    x = torch.minimum(torch.maximum(y, lbv), ubv)
    viol = (x * tg).sum(-1) - rhs
    pos = tg > 0
    hi = torch.where(pos, (y - lbv) / torch.where(pos, tg, 1.0), 0.0)
    hi = torch.clamp(hi.amax(-1), min=1.0)
    a = torch.zeros_like(hi)
    b = hi
    frac = torch.arange(1, GRID + 1, dtype=y.dtype, device=y.device) / GRID
    y_, lb_, ub_ = y[..., None, :], lbv[..., None, :], ubv[..., None, :]
    for _ in range(GRID_ROUNDS):
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


def fista_chunk_plain(x0, lam_c2, lbv, ubv, n_it: int, p: FistaTerms,
                      step: float, rho: float) -> torch.Tensor:
    """Reference version: ``n_it`` FISTA iterations from x0 [..., n] with
    multipliers lam_c2 [..., C2] and bounds [..., n] -> x [..., n]."""
    x, y = x0, x0
    t = torch.ones(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    for _ in range(n_it):
        g = _al_grad(y, lam_c2, rho, p)
        xn = _project(y - step * g, lbv, ubv, p)
        # gradient-based adaptive restart (O'Donoghue & Candes)
        restart = (g * (xn - x)).sum(-1) > 0
        tn = torch.where(restart, 1.0, 0.5 * (1 + torch.sqrt(1 + 4 * t * t)))
        yn = _project(xn + ((t - 1) / tn)[..., None] * (xn - x), lbv, ubv, p)
        y = torch.where(restart[..., None], xn, yn)
        x, t = xn, tn
    return x


# ---- the kernel

def fista_chunk(x0, lam_c2, lbv, ubv, n_it: int, p: FistaTerms, step: float,
                rho: float, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x0, lbv, ubv float32 [n] or [S, n] (broadcast to the batch), lam_c2
    float32 [C2] or [S, C2] -> x float32 of the batch's shape.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    one launch a call.  ``stats``, int32 [S, 2] on the card, gets each
    problem's projections that ran the grid and its count of coordinates
    with lb < ub (what the kernel's bound counts)."""
    dev = x0.device
    if dev.type == "cpu":
        return fista_chunk_plain(x0, lam_c2, lbv, ubv, n_it, p, step, rho)
    if dev.type != "cuda":
        raise ValueError(f"fista_chunk: unsupported device {dev}")
    if p.folded is None:
        raise ValueError("fista_chunk: terms made for another device "
                         "(fista_terms(prob, 'cuda') folds them)")
    n, C2 = p.n, p.C2
    vecs = (x0, lbv, ubv)
    S = max(t.shape[0] if t.dim() == 2 else 1 for t in vecs)
    for t in vecs:
        if t.dim() not in (1, 2) or t.shape[-1] != n or (
                t.dim() == 2 and t.shape[0] not in (1, S)):
            raise ValueError(f"fista_chunk: shape {tuple(t.shape)}, expected "
                             f"[{n}] or [S, {n}]")
    shape = (S, n) if max(t.dim() for t in vecs) == 2 else (n,)
    xs, lbs, ubs = (t.expand(S, n).contiguous() for t in vecs)
    lam = lam_c2.expand(S, C2).contiguous()
    for name, t in (("x0", xs), ("lbv", lbs), ("ubv", ubs), ("lam_c2", lam)):
        check_tensor(t, name, torch.float32, dev, 2)
    f = p.folded
    for name, t in f.items():
        check_tensor(t, name, t.dtype, dev, 1)
    out = torch.empty(S, n, dtype=torch.float32, device=dev)
    if stats is None:
        stats = torch.empty(S, 2, dtype=torch.int32, device=dev)
    check_tensor(stats, "stats", torch.int32, dev, 2)
    if stats.shape != (S, 2):
        raise ValueError(f"stats: shape {tuple(stats.shape)}, expected ({S}, 2)")
    if S == 0 or n == 0:
        return out.reshape(shape)
    words = scratch_words(n, C2)
    scratch = (torch.empty(S * words, dtype=torch.float32, device=dev)
               if 4 * words > smem_cap() else None)
    KERNEL(xs.data_ptr(), lam.data_ptr(), lbs.data_ptr(), ubs.data_ptr(),
           p.tg.data_ptr(), f["h_ptr"].data_ptr(), f["h_col"].data_ptr(),
           f["h_val"].data_ptr(), f["hb"].data_ptr(), f["m_ptr"].data_ptr(),
           f["m_col"].data_ptr(), f["m_val"].data_ptr(), p.c2_rhs.data_ptr(),
           f["r_ptr"].data_ptr(), f["r_row"].data_ptr(), f["r_val"].data_ptr(),
           S, n, C2, int(p.has_c2), int(n_it), float(step), float(rho),
           float(p.rhs), out.data_ptr(), stats.data_ptr(),
           0 if scratch is None else scratch.data_ptr(), stream_ptr(dev))
    return out.reshape(shape)


def scratch_words(n: int, C2: int) -> int:
    """4-byte words a problem's working set takes: x, y, z, g, lb, ub and
    tg (n each), the free-coordinate list (n) and the multipliers (C2)."""
    return 8 * n + C2


@functools.cache
def smem_cap() -> int:
    """Bytes of a working set the kernel keeps in shared memory; past it,
    in device memory (the wrapper's scratch)."""
    from .build import load

    return load().cammiq_quant_fista_smem_cap()
