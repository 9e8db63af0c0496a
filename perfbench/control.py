"""The control of the comparison that decides ``correct``: the reference put
in the program's place with one of the configuration's guarantees broken,
which the comparison has to find.

The configuration states exact counts, which the program keeps in int32
counters.  The control keeps them in the nearest narrower type, int16,
which wraps (the temptation: half the bytes of the pass's counter copy):
the reference's counts taken modulo 2^16 into [-2^15, 2^15).  Its counts
are judged as the program's are (``compare.counts_diff``), for every
sample of a run's pool, on each seed given.  Run it on the card at a
cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

It prints one JSON line a seed: ``counts_diff`` of the control and of the
reference against itself (0), and the samples compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


class _Counts:
    """The reference's counts in the attribute form the comparison reads."""

    def __init__(self, d: dict):
        self.__dict__.update(d)


def wrap16(x):
    """Integers as an int16 counter holds them."""
    return (x + 2**15) % 2**16 - 2**15


def narrowed(ref: dict) -> dict:
    """The reference's counts kept in int16 counters."""
    out = {k: wrap16(np.asarray(ref[k], np.int64))
           for k in ("cnts_u", "cnts_d", "rcount_u", "rcount_d")}
    out.update(nundet=int(wrap16(ref["nundet"])), nconf=int(wrap16(ref["nconf"])),
               pair_counts={k: int(wrap16(v)) for k, v in ref["pair_counts"].items()})
    return out


def control_diffs(bench: dict, workload: str, seeds, device: str,
                  cache_root: str, traffic_dir=None, log=None) -> list:
    """[{seed, counts_diff, self_diff, samples}] of the control on each seed."""
    import torch

    from . import compare, harness
    from .reference.classify import classify
    from .reference.index import load_rows, probe_rows
    from .system import ensure_index

    kw = {"traffic_dir": traffic_dir} if traffic_dir else {}
    cell, cfg, traffic, _, _ = harness.load_cell(bench, workload, **kw)
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    index_dir, codes_path = ensure_index(cfg, cache_root, device, log)
    G = cfg["corpus"]["genomes"] + 1
    rows = probe_rows(load_rows(index_dir, cfg["build"]["Lmax"], torch.device(device)))
    out = []
    for seed in seeds:
        pool = harness.draw_pool(traffic, codes_path, seed, device)
        diff = same = 0
        for rs in pool:
            ref = classify(rows, rs.codes, G, device)
            diff += compare.counts_diff(_Counts(narrowed(ref)), ref, traffic["mode"])
            same += compare.counts_diff(_Counts(ref), ref, traffic["mode"])
        out.append({"seed": seed, "counts_diff": diff, "self_diff": same,
                    "samples": len(pool)})
        log(json.dumps(out[-1]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    import torch

    from .harness import HERE, ROOT

    if not torch.cuda.is_available():
        print("perfbench control: needs a CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for r in control_diffs(bench, a.workload, a.seeds, "cuda",
                           os.path.join(HERE, "cache")):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from perfbench.control import main as _main

    sys.exit(_main())
