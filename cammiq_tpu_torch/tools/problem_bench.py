"""Time ``build_problem`` of one checkout of the port by the share of the
unique entries that the prefilter keeps, on synthetic columns.

    python cammiq_tpu_torch/tools/problem_bench.py --repo DIR \\
        [--entries 7692489] [--doubly 2786] [--genomes 1000] \\
        [--kept 0,1,15,100,300,500,1000] [--reps 5] [--seed 0]

Imports ``cammiq_tpu_torch`` from ``--repo`` (any checkout of the port, so
two versions can be timed in turns on one host).  Draws a unique table of
``--entries`` entries whose owners are uniform over ``--genomes`` genomes,
a doubly table of ``--doubly`` entries, and one sample's counts; the
defaults are the sizes of the benchmark's config #3 index.  For each
count k of ``--kept`` it sets the prefilter to keep genomes 1 to k and
calls ``build_problem`` once on a fresh copy of the index object
(``first_ms``: with a grouping made once an index, that call makes it)
and ``--reps`` more times on the same object (``warm_ms``).  Prints one
JSON line a count: k, the kept share, both times and ``digest``, the
SHA-256 of every field of the problem by dtype, shape and bytes, which is
equal between two checkouts exactly when their problems are.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np

# the prefilter of ``inputs`` keeps exactly the genomes it is asked to
FINE = dict(read_cnt_thres=5, easy_to_identify_thres=1000, ilp_alpha=1e-3)
RL, NUM_READS, ERATE = 100, 10_000_000, 0.01


def tables(entries: int, doubly: int, genomes: int, seed: int):
    """(index_u, index_d): the port's FlatIndex with the columns that
    ``build_problem`` reads and an empty hash table."""
    from cammiq_tpu_torch.index.table import FlatIndex

    rng = np.random.default_rng(seed)

    def flat(E, rid1, rid2, is_doubly):
        return FlatIndex(
            h=26, kw=1, key_words=np.zeros((E, 1), np.uint32),
            length=rng.integers(26, 51, E).astype(np.int32),
            rid1=rid1.astype(np.int32), rid2=rid2.astype(np.int32),
            ucount1=rng.integers(1, 6, E).astype(np.int32),
            ucount2=rng.integers(1, 6, E).astype(np.int32),
            table_lo=np.zeros(8, np.uint32), table_hi=np.zeros(8, np.uint32),
            table_start=np.full(8, -1, np.int32),
            table_count=np.zeros(8, np.int32),
            max_probes=1, max_bucket=1, is_doubly=is_doubly)

    u = flat(entries, rng.integers(1, genomes + 1, entries),
             np.zeros(entries, np.int64), False)
    d = flat(doubly, rng.integers(1, genomes + 1, doubly),
             rng.integers(1, genomes + 1, doubly), True)
    return u, d


def inputs(index_u, index_d, genomes: int, k: int, seed: int):
    """The arguments of ``build_problem`` after the two tables, drawn so
    that the prefilter keeps genomes 1 to k of n = genomes + 1."""
    from cammiq_tpu_torch.config import FineParams

    n = genomes + 1
    rng = np.random.default_rng(seed + 1)
    on = np.zeros(n, bool)
    on[1:k + 1] = True
    cnts_u = np.where(on, rng.integers(10, 300, n), 0).astype(np.float64)
    cnts_d = np.where(on, rng.integers(6, 40, n), 0).astype(np.float64)
    nus = rng.integers(500, 1500, n).astype(np.float64)
    nds = rng.integers(0, 500, n).astype(np.float64)
    glength = rng.integers(250_000, 350_000, n)
    glength[0] = 0
    ru = rng.integers(0, 9, index_u.num_entries).astype(np.int32)
    rd = rng.integers(0, 9, index_d.num_entries).astype(np.int32)
    return (ru, rd, cnts_u, cnts_d, nus, nds, glength, RL, NUM_READS, ERATE,
            FineParams(**FINE)), on


def digest(problem) -> str:
    """SHA-256 of a QuantProblem, field by field: dtype, shape and bytes
    of each array, the repr of each number."""
    h = hashlib.sha256()
    for f in dataclasses.fields(problem):
        v = getattr(problem, f.name)
        h.update(f.name.encode())
        if isinstance(v, np.ndarray):
            h.update(f"{v.dtype.str}{v.shape}".encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def measure(entries, doubly, genomes, kept, reps, seed, log=print):
    from cammiq_tpu_torch.models.quant import build_problem

    index_u, index_d = tables(entries, doubly, genomes, seed)
    rows = []
    for k in kept:
        args, on = inputs(index_u, index_d, genomes, k, seed)
        fresh = copy.copy(index_u)      # a new object on the same columns
        t0 = time.perf_counter()
        prob = build_problem(fresh, index_d, *args)
        first = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(prob.exist0, on):
            raise AssertionError(f"the prefilter did not keep genomes 1-{k}")
        warm = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = build_problem(fresh, index_d, *args)
            warm.append((time.perf_counter() - t0) * 1e3)
        if digest(again) != digest(prob):
            raise AssertionError(f"k={k}: a warm call built another problem")
        row = {"kept_genomes": k,
               "kept_share": float(on[index_u.rid1].mean()),
               "first_ms": first, "warm_ms": warm,
               "warm_ms_median": statistics.median(warm) if warm else None,
               "digest": digest(prob)}
        log(json.dumps(row))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True, help="checkout to import the port from")
    ap.add_argument("--entries", type=int, default=7_692_489)
    ap.add_argument("--doubly", type=int, default=2786)
    ap.add_argument("--genomes", type=int, default=1000)
    ap.add_argument("--kept", default="0,1,15,100,300,500,1000",
                    help="comma-separated counts of kept genomes")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path[0] = repo      # not this file's directory: the port comes from --repo
    print(json.dumps({"repo": repo}))
    measure(args.entries, args.doubly, args.genomes,
            [int(k) for k in args.kept.split(",")], args.reps, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
