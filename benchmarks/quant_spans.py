"""A quant cell's samples with the port's tracer on: each sample's span
totals and ``solve_quant``'s counters, one JSON line a sample.

    python3 benchmarks/quant_spans.py --workload c4sj-quant \\
        [--seed 1] [--samples 8] [--device cuda]

Run from the root of a checkout that holds ``BENCHMARK.json``, the port
(``cammiq_tpu_torch``) and ``perfbench/``.  It makes the cell's set-up as
``perfbench/run.py`` does (the index from ``perfbench/cache/``, built there
if absent; the pool drawn from ``--seed``; a warm-up sample), then runs
``--samples`` samples of the pool in turn through the body of
``perfbench.system.System.run_sample`` with ``cammiq_tpu_torch.utils.timing``
on.  Each line holds the sample's spans in ms (``[count, total_ms]``),
``perfbench/spans.py``'s readings, and the ``info`` counters of
``solve_quant`` (``candidates``, ``c2_rows``, ``doubly_terms``,
``fista_chunks``, ``enum_size``, ``bnb_nodes``) and the pass's probe
counters (``probe.rows``, ``probe.level2``, ``probe.survivors`` from
``QuerySession.last_counters``, and ``level2_share`` = level2 / rows, the
share of the rows that reached the 64 MB bloom past its level-1 fold); a
last line holds the medians.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

COUNTERS = ("candidates", "c2_rows", "doubly_terms", "fista_chunks",
            "enum_size", "bnb_nodes", "probe.rows", "probe.level2",
            "probe.survivors")


def quant_sample(system, reads):
    """``System.run_sample``'s quant body, keeping ``solve_quant``'s info
    with the pass's probe counters added."""
    from cammiq_tpu_torch.models.quant import build_problem, solve_quant

    counts = system.sess.run(reads, with_rcounts=True)
    gl, nus, nds = system.table.arrays()
    prob = build_problem(
        system.index_u, system.index_d, counts.rcount_u, counts.rcount_d,
        counts.cnts_u.astype(np.float64), counts.cnts_d.astype(np.float64),
        nus.astype(np.float64), nds.astype(np.float64), gl,
        counts.mean_read_len, counts.num_reads, system.erate, system.fine)
    _, _, info = solve_quant(prob, device=system.device)
    return {**info, **system.sess.last_counters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    from cammiq_tpu_torch.utils import timing
    from perfbench import spans
    from perfbench.harness import draw_pool, load_cell
    from perfbench.system import System, ensure_index

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _, cfg, traffic, _, _ = load_cell(bench, a.workload)
    if traffic["mode"] != "quant":
        raise SystemExit(f"{a.workload} is not a quant cell")
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    index_dir, codes_path = ensure_index(
        cfg, os.path.join(ROOT, "perfbench", "cache"), a.device, log)
    pool = draw_pool(traffic, codes_path, a.seed, a.device)
    system = System(cfg, index_dir, "quant", a.device)
    quant_sample(system, pool[0])           # warm-up, tracer off
    rows = []
    timing.enable()
    try:
        for k in range(a.samples):
            timing.take()
            info = quant_sample(system, pool[k % len(pool)])
            totals = timing.take().totals()
            row = {"sample": k % len(pool),
                   "spans_ms": {n: [c, ns / 1e6] for n, (c, ns, _) in
                                sorted(totals.items())},
                   "readings": spans.readings(totals),
                   "info": {c: info.get(c) for c in COUNTERS}}
            if info.get("probe.rows"):
                row["info"]["level2_share"] = (info["probe.level2"]
                                               / info["probe.rows"])
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        timing.disable()
        system.close()
    names = sorted({n for r in rows for n in r["spans_ms"]})
    print(json.dumps({"median_ms": {
        n: statistics.median(r["spans_ms"].get(n, [0, 0.0])[1] for r in rows)
        for n in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
