"""The port's quantification solver against the JAX solver on the instances
of test_quant_exact.py / test_quant_beyond_cap.py: the same EXIST set and
abundances within 1e-3 L1 (BASELINE.md).  The tolerance covers float32
step-size differences: the power-iteration start cannot be drawn from
jax.random's stream."""

import numpy as np
import pytest
import torch

from cammiq_tpu.models.quant import abundances, build_problem
from cammiq_tpu.models.quant import solve_quant as jax_solve_quant
from cammiq_tpu_torch.models.quant import solve_quant
from test_quant_exact import make_instance

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)

CASES = [
    # (seed, make_instance kwargs, enum_cap): unconstrained, constrained
    # (EXP1/EXP2 rows active), beyond the enumeration window, and the
    # exact branch-and-bound
    (1000, {}, 6),
    (1002, {}, 6),
    (7000, dict(n_sp=5, easy_thres=30, total_slack=(1.15, 1.6),
                ilp_alpha=1e-4), 6),
    (7001, dict(n_sp=5, easy_thres=30, total_slack=(1.15, 1.6),
                ilp_alpha=1e-4), 6),
    (42000, dict(n_sp=11, per_genome_u=3, n_d=12), 6),
    (91001, dict(n_sp=11, per_genome_u=3, n_d=12), 4),
]


@pytest.mark.parametrize("seed,kwargs,enum_cap", CASES)
def test_solve_quant_matches_jax(seed, kwargs, enum_cap):
    inst = make_instance(np.random.default_rng(seed), **kwargs)
    prob = build_problem(
        inst["index_u"], inst["index_d"], inst["rcount_u"], inst["rcount_d"],
        inst["cnts_u"], inst["cnts_d"], inst["nus"], inst["nds"],
        inst["glength"], inst["rl"], inst["num_reads"], inst["erate"],
        inst["fine"])
    opts = dict(iters=1800, outer=6, enum_cap=enum_cap, enum_iters=400)
    je, jc, ji = jax_solve_quant(prob, **opts)
    te, tc, ti = solve_quant(prob, device="cpu", **opts)
    np.testing.assert_array_equal(te, je)
    assert np.abs(abundances(te, tc) - abundances(je, jc)).sum() <= 1e-3
    assert ti["stopped_by"] == ji["stopped_by"]
    assert te.any()


def test_solve_quant_no_candidates():
    inst = make_instance(np.random.default_rng(1000))
    fine = inst["fine"].__class__(read_cnt_thres=10**9,
                                  easy_to_identify_thres=0)
    prob = build_problem(
        inst["index_u"], inst["index_d"], inst["rcount_u"], inst["rcount_d"],
        inst["cnts_u"], inst["cnts_d"], inst["nus"], inst["nds"],
        inst["glength"], inst["rl"], inst["num_reads"], inst["erate"], fine)
    exist, cov, info = solve_quant(prob, device="cpu")
    assert not exist.any() and not cov.any() and info["objective"] == 0.0
