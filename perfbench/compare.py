"""What decides ``correct``: each number compared and its limit.

Every count is exact (the configuration's guarantee: CAMMiQ's counts bit
for bit), so its limit is 0; the abundance L1 has the limit the
configuration states (1e-3, BASELINE.md:28).

- ``index_bad_rows``: index rows whose labels or occurrence counts the
  database contradicts, plus original entries with no row
  (``reference/index.py``);
- ``counts_diff``: over every sample the window and the traced run
  produced, the summed absolute differences of ``cnts_u``, ``cnts_d``,
  ``nundet``, ``nconf``, and in quant ``rcount_u``/``rcount_d``, in Type-II
  the pair counts, from the reference's counts of that sample;
- ``answer_diff``: quant, genomes whose EXIST differs from the
  reference's MIQP optimum (``reference/quant.py``) plus output lines that
  are wrong or missing; Type-II, the violations ``reference/answers.py``
  counts;
- ``abund_l1``: quant, the largest L1 distance of the printed abundances
  from the reference's.
"""

from __future__ import annotations

import numpy as np

from .reference.answers import judge_ident, judge_quant

LIMITS = {"index_bad_rows": 0, "counts_diff": 0, "answer_diff": 0,
          "abund_l1": 1e-3}


def counts_diff(got, ref: dict, mode: str) -> int:
    d = sum(int(np.abs(np.asarray(getattr(got, k), np.int64)
                       - np.asarray(ref[k], np.int64)).sum())
            for k in ("cnts_u", "cnts_d"))
    d += abs(got.nundet - ref["nundet"]) + abs(got.nconf - ref["nconf"])
    if mode == "quant":
        for k in ("rcount_u", "rcount_d"):
            a, b = np.asarray(getattr(got, k), np.int64), np.asarray(ref[k], np.int64)
            d += (int(np.abs(a - b).sum()) if a.shape == b.shape
                  else int(np.abs(a).sum() + np.abs(b).sum()) or 1)
    if mode == "type2":
        keys = set(got.pair_counts) | set(ref["pair_counts"])
        d += sum(abs(got.pair_counts.get(k, 0) - ref["pair_counts"].get(k, 0))
                 for k in keys)
    return d


def sample_name(k: int) -> str:
    return f"sample{k}"


def judge(mode: str, results, refs: dict, index_check: dict) -> dict:
    """The numbers compared, from ``results`` [(pool index, SampleResult)]
    and ``refs`` {pool index: reference counts, and in quant ``"quant"``,
    the reference's (EXIST, abundances)}."""
    out = {"index_bad_rows": index_check["bad_rows"], "counts_diff": 0,
           "answer_diff": 0}
    if mode == "quant":
        out["abund_l1"] = 0.0
    bad_samples = 0
    for k, res in results:
        ref = refs[k]
        d = counts_diff(res.counts, ref, mode)
        a = 0
        if mode == "quant":
            q = judge_quant(*ref["quant"], sample_name(k), res.exist, res.text)
            a = q["exist_diff"] + q["lines_diff"]
            out["abund_l1"] = max(out["abund_l1"], q["abund_l1"])
        elif mode == "type2":
            a = judge_ident(ref, res.exist, res.redist)["ident_bad"]
        out["counts_diff"] += d
        out["answer_diff"] += a
        bad_samples += int(d > 0 or a > 0)
    return {"numbers": out, "bad_samples": bad_samples}


def verdict(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())
