"""The repository's synthetic benchmark data: genomes and read batches.

Copies of ``benchmarks/build_scale.py:gen_genomes`` and
``bench.py:sample_read_batch``, the generator and read sampler behind the
BASELINE config-#3 shape (1000 genomes x 300 kb, ``bench.py``'s
``BENCH_GENOMES`` x ``BENCH_GLEN``).  The same seed gives the same bytes as
the originals (tested).
"""

from __future__ import annotations

import numpy as np

from ..ops.packing import SYMBOL_IDX

BENCH_GENOMES = 1000
BENCH_GLEN = 300_000


def gen_genomes(num, glen, seed=0, shared_pool=16, shared_len_frac=0.02):
    """Random genomes with segments drawn from a shared pool, so unique,
    doubly-unique, and >2-genome content all exist."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    seg = max(int(glen * shared_len_frac), 1000)
    pool = [rng.integers(0, 4, size=seg).astype(np.int8) for _ in range(shared_pool)]
    genomes = []
    for g in range(num):
        own = rng.integers(0, 4, size=glen).astype(np.int8)
        # splice 2 pool segments at random positions (some pairs of genomes
        # will share a segment -> doubly-unique material)
        for _ in range(2):
            p = pool[int(rng.integers(0, shared_pool))]
            at = int(rng.integers(0, glen - seg))
            own[at : at + seg] = p
        genomes.append([alpha[own].tobytes()])
    return genomes


def sample_read_batch(rng, genomes, batch, L=100, Lpad=100, erate=0.01,
                      rc_frac=0.5):
    num = len(genomes)
    codes = np.zeros((batch, Lpad), np.int8)
    lengths = np.full(batch, L, np.int32)
    gsel = rng.integers(0, num, size=batch)
    for b in range(batch):
        c = genomes[gsel[b]][0]
        p = int(rng.integers(0, len(c) - L))
        arr = SYMBOL_IDX[np.frombuffer(c[p : p + L], np.uint8)]
        codes[b, :L] = arr
    errs = rng.random((batch, L)) < erate
    codes[:, :L] = np.where(errs, rng.integers(0, 4, size=(batch, L)),
                            codes[:, :L])
    # reverse-complement half the reads (production read sets hit both
    # strands; the classifier handles RC via the key augmentation)
    flip = rng.random(batch) < rc_frac
    rc = (3 - codes[flip, :L])[:, ::-1]
    codes[flip, :L] = rc
    return codes, lengths
