"""The reference against the port on a tiny database on the CPU, the result
line's schema, the faults a run must catch, and the control."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import compare, control, harness
from perfbench.reference import answers, quant
from perfbench.reference.index import check_index, load_rows
from perfbench.system import ensure_index

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "testdata")
CASES = [("tiny", "quant"), ("tiny-gather", "type1"), ("tiny", "type2"),
         ("tiny-gather", "quant")]


def bench(cfg, mode):
    return {"configs": [{"name": cfg, "file": f"perfbench/testdata/{cfg}.json"}],
            "workloads": [{"name": "t", "config": cfg, "traffic": f"tiny-{mode}",
                           "chips": 1}],
            "end_to_end": [{"name": "reads_per_s", "unit": "reads/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": n, "unit": "ms"} for n in
                          ("pass_ms", "problem_ms", "solve_ms.quant",
                           "solve_ms.ident", "idle_pct", "reads_per_s.type2")]}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    torch.set_num_threads(1)
    return str(tmp_path_factory.mktemp("perfbench_cache"))


def run(cache, cfg, mode, trace=False, seed=2**31 + 11):
    return harness.run_cell(bench(cfg, mode), "t", seed, 0.2, trace, "cpu",
                            0.0, cache, log=lambda m: None, traffic_dir=DATA)


@pytest.mark.parametrize("cfg,mode", CASES)
def test_reference_matches_port(cache, cfg, mode):
    out = run(cache, cfg, mode)
    assert out["correct"], out["compared"]
    assert all(v["value"] == 0 for k, v in out["compared"].items() if k != "abund_l1")
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_result_line_schema(cache):
    out = run(cache, "tiny", "quant", trace=True)
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(out)[-1] == "compared"
    assert set(out["compared"]) == {"index_bad_rows", "counts_diff", "answer_diff",
                                    "abund_l1"}
    assert all(set(v) == {"value", "limit"} for v in out["compared"].values())
    assert set(out["metrics"]) == {"pass_ms", "problem_ms", "solve_ms.quant",
                                   "reads_per_s.type2"}
    assert out["metrics"]["reads_per_s.type2"]["value"] > 0
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)
    out = run(cache, "tiny", "type1")
    assert set(out["metrics"]) == {"reads_per_s", "setup_s"}
    assert out["metrics"]["reads_per_s"]["value"] > 0


def _fault_half_batch(monkeypatch):
    """Half of every batch left out."""
    from cammiq_tpu_torch.query import pipeline

    up = pipeline._Upload.__call__

    def half(self, codes, lengths):
        lengths = lengths.copy()
        lengths[lengths.shape[0] // 2:] = 0
        return up(self, codes, lengths)

    monkeypatch.setattr(pipeline._Upload, "__call__", half)


def _fault_count_altered(monkeypatch):
    """One genome's count altered where the session produces it."""
    from cammiq_tpu_torch.query import pipeline

    run_ = pipeline.QuerySession.run

    def altered(self, *a, **k):
        out = run_(self, *a, **k)
        out.cnts_u[1] += 1
        return out

    monkeypatch.setattr(pipeline.QuerySession, "run", altered)


def _fault_answer_altered(monkeypatch, mode):
    """The solver's answer altered where it is produced."""
    from cammiq_tpu_torch.models import ident, quant

    if mode == "quant":
        solve = quant.solve_quant

        def altered(*a, **k):
            exist, cov, info = solve(*a, **k)
            exist = exist.copy()
            exist[1] = not exist[1]         # genome 1 in or out of EXIST
            cov = cov.copy()
            cov[1] = 1.0
            return exist, cov, info

        monkeypatch.setattr(quant, "solve_quant", altered)
    else:
        solve = ident.solve_ident

        def altered(*a, **k):
            exist, redist = solve(*a, **k)
            redist = redist.copy()
            redist[1] += 1
            return exist, redist

        monkeypatch.setattr(ident, "solve_ident", altered)


@pytest.mark.parametrize("fault", ["half_batch", "count_altered", "answer_altered"])
@pytest.mark.parametrize("cfg,mode", CASES[:3])
def test_faults_are_caught(cache, monkeypatch, fault, cfg, mode):
    if fault == "answer_altered" and mode == "type1":
        pytest.skip("Type-I's answer is its counts")
    if fault == "half_batch":
        _fault_half_batch(monkeypatch)
    elif fault == "count_altered":
        _fault_count_altered(monkeypatch)
    else:
        _fault_answer_altered(monkeypatch, mode)
    out = run(cache, cfg, mode)
    assert not out["correct"], out["compared"]
    assert out["failed"] >= 1


def test_index_check_catches_a_wrong_label(cache):
    cfg = json.load(open(os.path.join(DATA, "tiny-gather.json")))
    index_dir, codes = ensure_index(cfg, cache, "cpu", lambda m: None)
    rows = load_rows(index_dir, cfg["build"]["Lmax"], torch.device("cpu"))
    g = torch.from_numpy(np.load(codes))
    assert check_index(rows, g, cfg["build"]["L"])["bad_rows"] == 0
    rows["rid1"][5] = rows["rid1"][5] % 8 + 1
    rows["ucount1"][7] += 1
    assert check_index(rows, g, cfg["build"]["L"])["bad_rows"] == 2


def test_control_fails(cache):
    """int16 counters wrap once a genome counts 2^15 reads: the control's
    counts differ from the reference's on every seed."""
    b = bench("tiny-gather", "control")
    out = control.control_diffs(b, "t", [1, 2**31 + 3], "cpu", cache,
                                traffic_dir=DATA, log=lambda m: None)
    assert all(r["counts_diff"] > 0 and r["self_diff"] == 0 for r in out), out


def test_counts_diff_limits():
    assert compare.verdict({"counts_diff": 0, "abund_l1": 1e-3})
    assert not compare.verdict({"counts_diff": 1})
    assert not compare.verdict({"abund_l1": 2e-3})
    assert control.wrap16(np.array([32767, 32768, 65536])).tolist() == [32767, -32768, 0]


@pytest.mark.parametrize("cfg", ["tiny", "tiny-4k"])
def test_lmer_bounds_hold_the_builds_counts(cache, cfg):
    """The L-mer count bounds the reference derives from the database hold
    the counts the build wrote (read here only to test the bounds)."""
    c = json.load(open(os.path.join(DATA, f"{cfg}.json")))
    index_dir, codes = ensure_index(c, cache, "cpu", lambda m: None)
    rows = load_rows(index_dir, c["build"]["Lmax"], torch.device("cpu"))
    lm = check_index(rows, torch.from_numpy(np.load(codes)), c["build"]["L"])["lmers"]
    base = os.path.dirname(codes)
    for key, f in (("nus", "unique_lmer_count_u.out"), ("nds", "unique_lmer_count_d.out")):
        built = np.array([0] + [int(x.split()[1]) for x in open(os.path.join(base, f))])
        lo, hi = lm[key]
        assert (lo <= built).all() and (built <= hi).all(), (key, lo, built, hi)
    assert (lm["nus"][0][1:] > 0).all()


def test_prefilter_undecided_between_bounds():
    def lm(us, ds):
        return {"nus": tuple(np.array([0] + list(x)) for x in zip(*us)),
                "nds": tuple(np.array([0] + list(x)) for x in zip(*ds))}

    # easy genomes: 100 reads of each kind decide, whatever the counts
    keep, easy = answers.quant_candidates(
        [0, 150, 99], [0, 150, 200], lm([(12000, 30000)] * 2, [(1, 30000)] * 2))
    assert keep.tolist() == [False, True, False] and easy.tolist() == [False, True, True]
    with pytest.raises(answers.Undecided):      # easy or not
        answers.quant_candidates([0, 150], [0, 150], lm([(9000, 12000)], [(1, 30000)]))
    # a genome under the easy count: no doubly reads pass only if it has none
    keep, _ = answers.quant_candidates([0, 5], [0, 0], lm([(100, 5000)], [(1, 5000)]))
    assert keep.tolist() == [False, False]
    with pytest.raises(answers.Undecided):
        answers.quant_candidates([0, 5], [0, 0], lm([(100, 5000)], [(0, 5000)]))


@pytest.mark.parametrize("seed", range(4))
def test_branch_and_bound_finds_the_best_assignment(seed):
    """The search against every assignment, on random problems whose
    genomes are partly easy (forced in) and partly not."""
    rng = np.random.default_rng(seed)
    n, eu, ed = 7, 60, 12
    pu = {"rid1": rng.integers(1, n, eu), "rid2": np.zeros(eu, np.int64),
          "ucount1": rng.integers(1, 3, eu), "ucount2": np.zeros(eu, np.int64),
          "length": rng.integers(20, 40, eu)}
    g1 = rng.integers(1, n, ed)
    pd = {"rid1": g1, "rid2": g1 % (n - 1) + 1, "ucount1": np.ones(ed, np.int64),
          "ucount2": np.ones(ed, np.int64), "length": rng.integers(20, 40, ed)}
    cov = np.where(rng.random(n) < 0.5, rng.uniform(0.5, 5.0, n), 0.0)
    ru = rng.poisson(cov[pu["rid1"]] * 30)
    rd = rng.poisson((cov[pd["rid1"]] + cov[pd["rid2"]]) * 30)
    cu = np.bincount(pu["rid1"], ru, minlength=n)
    cd = np.bincount(pd["rid1"], rd, minlength=n)
    cand = np.ones(n, bool)
    cand[0] = False
    easy = rng.random(n) < 0.3
    args = (pu, pd, ru, rd, cu, cd, cand, easy, np.full(n, 5000), 100, 100000, 0.01)
    qp, forced = quant.model(*args)
    sel, c, val = quant.branch_and_bound(qp, forced)
    k = forced.shape[0]
    best = np.inf
    for m in range(1 << k):
        s = np.array([(m >> i) & 1 for i in range(k)], bool)
        _, v, ok = qp(np.where(s, 0.01, np.nan))
        if ok:
            best = min(best, v)
    assert val == pytest.approx(best, rel=1e-6, abs=1e-6)
