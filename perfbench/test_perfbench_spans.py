"""``perfbench/spans.py``: its readings of the port's tracer on a tiny cell
run by the harness on the CPU, and its arithmetic on hand-made totals."""

import pytest
import torch

from cammiq_tpu_torch.utils import timing
from perfbench import harness, spans
from perfbench.test_perfbench_reference import DATA, bench


@pytest.mark.parametrize("cfg,mode", [("tiny", "quant"), ("tiny-gather", "type1"),
                                      ("tiny", "type2")])
def test_spans_of_a_tiny_cell(tmp_path, monkeypatch, cfg, mode):
    """The harness's run with the tracer on, its totals taken around each
    sample as a reader of the window would have them."""
    from perfbench.system import System

    torch.set_num_threads(1)
    taken = []
    run_sample = System.run_sample

    def sample(self, *a, **k):
        taken.append(("before", timing.take()))
        res = run_sample(self, *a, **k)
        taken.append(("sample", timing.take()))
        return res

    monkeypatch.setattr(System, "run_sample", sample)
    timing.take()
    with timing.tracing():
        out = harness.run_cell(bench(cfg, mode), "t", 2**31 + 5, 0.2, False,
                               "cpu", 0.0, str(tmp_path), log=lambda m: None,
                               traffic_dir=DATA)
    timing.take()
    assert out["correct"]
    rows = [spans.readings(r.totals()) for kind, r in taken if kind == "sample"]
    assert len(rows) >= 2
    for r in rows:
        assert {"stage_ms", "issue_ms", "drain_ms", "query_run_ms"} <= set(r)
        assert ("pair_lookup_ms" in r) == (mode == "type2")
        assert ("problem_scan_ms" in r) == (mode == "quant")
        assert "upload_wait_ms" not in r            # no upload ring on the CPU
        assert 0 < r["cover_pass"] <= 1
        if mode == "quant":
            assert 0 < r["cover_build_problem"] <= 1
    assert rows[-1]["passes"] == 1                  # after the warm-up
    assert spans.session_start_s(taken[0][1].totals()) > 0


def test_readings_arithmetic():
    totals = {"pass.stage": [307, 4_000_000, 50_000],
              "pass.classify": [153, 6_000_000, 90_000],
              "problem.entry_sizes": [1, 2_000_000, 2_000_000],
              "problem.entry_weights": [1, 3_000_000, 3_000_000]}
    assert spans.readings(totals) == {"stage_ms": 4.0, "issue_ms": 6.0,
                                      "problem_scan_ms": 5.0}
    totals["query.pass"] = [2, 20_000_000, 11_000_000]
    r = spans.readings(totals)
    assert (r["cover_pass"], r["passes"]) == (0.5, 2)
    assert spans.readings({}) == {}


def test_session_start_and_cover():
    tot = {"session.open": [2, 1_000_000_000, 900_000_000],
           "kernels.load": [1, 500_000_000, 500_000_000],
           "query.run": [1, 7, 7]}
    assert spans.session_start_s(tot) == 1.5
    assert spans.session_start_s({"query.run": [1, 7, 7]}) is None
    parts = {"quant.build_problem": 10.0, "problem.terms": 4.0,
             "problem.bounds": 5.0}
    assert spans.cover(lambda names: sum(parts.get(n, 0) for n in names)) == {
        "cover_build_problem": 0.9}
    assert spans.cover(lambda names: 0.0) == {}
