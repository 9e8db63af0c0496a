"""The benchmark's database and read samples, made from seeds.

``gen_genomes`` is a frozen copy of ``benchmarks/build_scale.py:gen_genomes``
(the same bytes from the same seed): the config-#3 database of random
genomes with segments spliced in from a small shared pool.
``draw_community`` and ``draw_reads`` draw a sample in the shape of
``benchmarks/realized_free.py``'s mixture (``present`` genomes in
lognormal(0, 1) abundance, fixed-length reads, uniform substitutions, half
reverse-complemented), vectorised: a few torch calls a chunk of reads on
the card instead of a Python loop a read, so the draws differ from the
original's.
"""

from __future__ import annotations

import numpy as np

# ASCII -> 2-bit code (A=0, C=1, G=2, T=3); the database holds only ACGT
_CODE = np.full(256, -1, np.int8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


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


def genome_codes(genomes) -> np.ndarray:
    """int8 [G, glen] 2-bit codes of single-contig genomes of one length."""
    return _CODE[np.frombuffer(b"".join(g[0] for g in genomes), np.uint8)
                 ].reshape(len(genomes), -1)


def revcomp(codes):
    """Reverse complement of 2-bit code rows (the last axis)."""
    return (3 - codes).flip(-1)


def draw_community(gen, num_genomes: int, present: int, sigma: float):
    """(genome ids 0-based [present], abundance weights [present]) on
    ``gen``'s device: ``present`` genomes in lognormal(0, sigma) abundance."""
    import torch

    ids = torch.randperm(num_genomes, generator=gen, device=gen.device)[:present]
    w = torch.empty(present, dtype=torch.float64, device=gen.device).log_normal_(
        0.0, sigma, generator=gen)
    return ids, w / w.sum()


def draw_reads(gen, codes, ids, weights, reads: int, read_len: int,
               erate: float, rc_frac: float, chunk: int = 1 << 18) -> np.ndarray:
    """int8 [reads, read_len] on the host, drawn with the torch generator
    ``gen`` from the genomes ``codes`` (int8 [G, glen] on its device): each
    read from genome ``ids[k]`` with probability ``weights[k]``, at a
    uniform start, each base substituted with probability ``erate`` by a
    uniform base (which may be the same one), and a fraction ``rc_frac``
    reverse-complemented."""
    import torch

    dev = codes.device
    G, glen = codes.shape
    flat = codes.reshape(-1)
    col = torch.arange(read_len, device=dev)
    out = torch.empty(reads, read_len, dtype=torch.int8)
    for s in range(0, reads, chunk):
        n = min(chunk, reads - s)
        g = ids[torch.multinomial(weights, n, replacement=True, generator=gen)]
        start = g * glen + torch.randint(0, glen - read_len, (n,), generator=gen,
                                         device=dev)
        r = flat[start[:, None] + col]
        sub = torch.rand(n, read_len, generator=gen, device=dev) < erate
        r = torch.where(sub, torch.randint(0, 4, (n, read_len), generator=gen,
                                           device=dev, dtype=torch.int8), r)
        flip = torch.rand(n, 1, generator=gen, device=dev) < rc_frac
        out[s:s + n] = torch.where(flip, revcomp(r), r).cpu()
    return out.numpy()
