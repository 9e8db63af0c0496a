"""Time steady-state query passes of one checkout of the port on the card.

    python cammiq_tpu_torch/tools/pass_bench.py --repo DIR --merged DIR \\
        [--passes 5]

Imports ``cammiq_tpu_torch`` from ``--repo`` (any checkout of the port, so
two versions can be timed in turns on one card, e.g. parent, change,
change, parent), opens a session on the merged artifact at ``--merged``
(the config-#3 one ``chip_smoke.py`` builds into ``bench_cache/``),
samples the reads ``chip_smoke.py`` samples (16 batches of 8192 from the
bench generator, seed 1), warms up with one pass of each mode, then times
``--passes`` quant and sc-mode passes in turns (host clock around
``QuerySession.run``, which ends in its blocking transfer).  Prints one
JSON line: the checkout, the card, each pass's seconds and the median
reads/s by mode.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True, help="checkout to import the port from")
    ap.add_argument("--merged", required=True, help="merged artifact directory")
    ap.add_argument("--passes", type=int, default=5)
    args = ap.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path[0] = repo      # not this file's directory: the port comes from --repo

    import numpy as np
    import torch

    from cammiq_tpu_torch.config import QueryConfig
    from cammiq_tpu_torch.index.artifact import load_merged_artifact
    from cammiq_tpu_torch.io.fastq import ReadSet
    from cammiq_tpu_torch.query.pipeline import QuerySession
    from cammiq_tpu_torch.tools.benchdata import (BENCH_GENOMES, BENCH_GLEN,
                                                  gen_genomes, sample_read_batch)

    if not torch.cuda.is_available():
        print("pass_bench: no CUDA device", file=sys.stderr)
        return 2
    genomes = gen_genomes(BENCH_GENOMES, BENCH_GLEN)
    rng = np.random.default_rng(1)
    parts = [sample_read_batch(rng, genomes, 8192) for _ in range(16)]
    del genomes
    lengths = np.concatenate([p[1] for p in parts])
    reads = ReadSet(codes=np.concatenate([p[0] for p in parts]), lengths=lengths,
                    total_len=int(lengths.sum()), name="bench")
    art = load_merged_artifact(args.merged)
    sess = QuerySession.from_artifact(
        art, BENCH_GENOMES + 1, QueryConfig(h=art.h, erate=0.01, batch_size=8192),
        device="cuda")
    passes = {"quant": [], "sc": []}
    for i in range(args.passes + 1):
        for mode in (("quant", "sc") if i % 2 else ("sc", "quant")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sess.run(reads, sc_mode=mode == "sc")
            if i:                          # pass 0 warms up
                passes[mode].append(time.perf_counter() - t)
    print(json.dumps({
        "repo": repo, "device": torch.cuda.get_device_name(0),
        "pass_s": passes,
        "reads_per_s": {m: reads.num_reads / statistics.median(p)
                        for m, p in passes.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
