"""The port's quantification solver against the brute-force MIQP oracle
(``tests/quant_oracle.py``: scipy's SLSQP on every EXIST assignment) on
instances of ``tests/test_quant_exact.py`` and
``tests/test_quant_beyond_cap.py``, solved on the CPU (the FISTA chunk's
plain version): the same EXIST set and abundances within 1e-3 L1.  The
instances come from ``torch_fixture.make_instance``, held here to the
JAX package's ``make_instance`` draw for draw."""

import dataclasses

import numpy as np
import pytest
import torch

from cammiq_tpu_torch.models.quant import solve_quant
from quant_oracle import oracle_miqp
from test_quant_exact import make_instance as jax_make_instance
from torch_fixture import (QUANT_BEYOND_CAP, QUANT_CONSTRAINED,
                           QUANT_UNCONSTRAINED, make_instance, quant_problem)

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)

KINDS = {"unconstrained": QUANT_UNCONSTRAINED,
         "constrained": QUANT_CONSTRAINED, "beyond_cap": QUANT_BEYOND_CAP}
CASES = (
    # test_quant_exact.py's unconstrained and constrained instances (seeds
    # 1000 + i and 7000 + i) with its enum_cap of 6, and the first
    # beyond-cap instance of test_quant_beyond_cap.py (8 free candidates,
    # enum_cap 6: the windowed enumeration)
    [(1000 + i, "unconstrained", 6) for i in (0, 3, 11, 24, 47, 89)]
    + [(7000 + i, "constrained", 6) for i in (0, 2, 4, 6, 8, 11)]
    + [(42000, "beyond_cap", 6)]
)


def _abundances(exist, cov):
    total = cov[exist].sum()
    return np.where(exist, cov, 0.0) / total if total > 0 else np.zeros_like(cov)


@pytest.mark.parametrize("seed,kind,enum_cap", CASES)
def test_solve_quant_matches_oracle(seed, kind, enum_cap):
    prob = quant_problem(seed, **KINDS[kind])
    exist, cov, info = solve_quant(prob, iters=1800, outer=6,
                                   enum_cap=enum_cap, enum_iters=400,
                                   device="cpu")
    inst = make_instance(np.random.default_rng(seed), **KINDS[kind])
    osel, ocov, oobj = oracle_miqp(
        inst["index_u"], inst["index_d"], inst["rcount_u"], inst["rcount_d"],
        inst["cnts_u"], inst["cnts_d"], inst["nus"], inst["nds"],
        inst["glength"], inst["rl"], inst["num_reads"], inst["erate"],
        inst["fine"])
    assert np.isfinite(oobj)
    if kind == "beyond_cap":
        assert info["free_candidates"] > enum_cap and info["enum_rounds"] >= 2
    np.testing.assert_array_equal(exist, osel)
    assert np.abs(_abundances(exist, cov) - _abundances(osel, ocov)).sum() <= 1e-3


@pytest.mark.parametrize("kind", list(KINDS))
def test_make_instance_is_the_jax_package_s(kind):
    """The JAX-free copy draws what test_quant_exact.make_instance draws."""
    got = make_instance(np.random.default_rng(3), **KINDS[kind])
    want = jax_make_instance(np.random.default_rng(3), **KINDS[kind])
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.startswith("index_"):
            for f in dataclasses.fields(v):
                np.testing.assert_array_equal(getattr(got[k], f.name),
                                              getattr(v, f.name), err_msg=k)
        elif k == "fine":
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(v)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fold_terms_give_the_plain_gradient(kind):
    """The kernel's folded terms (kernels/quant_fista.py:fold_terms) give
    the plain version's augmented-Lagrangian gradient and C2 row sums, in
    float64 on random points and multipliers, a dropped row (a term whose
    owner has no C2 row) included."""
    from cammiq_tpu_torch.kernels import quant_fista as kqf

    prob = quant_problem(7, **dict(KINDS[kind], n_sp=12, n_d=20))
    rng = np.random.default_rng(1)
    if kind == "constrained":   # drop row 0: its terms read row C2 - 1
        assert len(prob.c2_species) >= 3
        prob.c2_species = prob.c2_species[1:]
        prob.c2_rhs = prob.c2_rhs[1:]
    terms = kqf.fista_terms(prob, "cpu")
    f = {k: torch.from_numpy(v) for k, v in kqf.fold_terms(
        prob, terms.trow.numpy(), terms.trow_read.numpy()).items()}
    t64 = dataclasses.replace(terms, tg=torch.from_numpy(prob.total_g), **{
        k: torch.from_numpy(np.asarray(getattr(prob, k), np.float64)) for k in
        ("uw", "ur", "uf", "dw1", "dw2", "dr", "df", "c2_rhs")})
    x = torch.from_numpy(rng.random((4, prob.n)) * 3)
    lam = torch.from_numpy(rng.random((4, terms.C2)))
    rho = 0.7

    def csr_mv(ptr, col, val, v):
        rows = torch.repeat_interleave(torch.arange(len(ptr) - 1),
                                       (ptr[1:] - ptr[:-1]).long())
        out = torch.zeros(v.shape[:-1] + (len(ptr) - 1,), dtype=torch.float64)
        return out.index_add_(-1, rows, val.double() * v[..., col.long()])

    e2 = csr_mv(f["m_ptr"], f["m_col"], f["m_val"], x)
    g = csr_mv(f["h_ptr"], f["h_col"], f["h_val"], x) - f["hb"]
    if terms.has_c2:
        mults = torch.clamp(lam + rho * (t64.c2_rhs - e2), min=0.0)
        g -= csr_mv(f["r_ptr"], f["r_row"], f["r_val"], mults)
    torch.testing.assert_close(e2, kqf.e2_rows(x, t64), rtol=1e-12, atol=1e-9)
    # R is float32: its values round at 6e-8
    torch.testing.assert_close(g, kqf._al_grad(x, lam, rho, t64), rtol=0,
                               atol=1e-6 * float(g.abs().max()))
    assert (kind == "constrained") == terms.has_c2
