"""Hand-made indexes, corpora and reads for the port's tests, built with
the port's own code: nothing of the JAX package is imported, so the
card-only tests use them on a host without it."""

from __future__ import annotations

import numpy as np

from cammiq_tpu_torch.config import BuildConfig
from cammiq_tpu_torch.index.table import build_flat_index_from_entries
from cammiq_tpu_torch.io.fasta import corpus_from_sequences
from cammiq_tpu_torch.io.fastq import reads_from_arrays
from cammiq_tpu_torch.query.merged import build_merged_index


ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def pair_genomes(seed, ng=5, glen=400, seg=90):
    """ng random genomes (int base codes) with one segment planted in
    exactly two genomes for each pair (g, g + 1 mod ng), so the doubly
    index has content.  Returns (genomes, [(genome, start)] of every
    planted copy)."""
    rng = np.random.default_rng(seed)
    gs = [rng.integers(0, 4, glen) for _ in range(ng)]
    planted = []
    for g in range(ng):
        s = rng.integers(0, 4, seg)
        for h in (g, (g + 1) % ng):
            at = int(rng.integers(0, glen - seg))
            gs[h][at:at + seg] = s
            planted.append((h, at))
    return gs, planted


def pair_corpus(seed, **kw):
    gs, _ = pair_genomes(seed, **kw)
    return corpus_from_sequences([[ALPHA[x].tobytes()] for x in gs])


def rc(codes):
    return [3 - c for c in reversed(codes)]


def _pack(codes, kw):
    w = [0] * kw
    for i, c in enumerate(codes):
        w[i // 16] |= (c & 3) << (2 * (i % 16))
    return w


def flat_table(keys, is_doubly, h, kw):
    n = len(keys)
    rid1 = np.arange(1, n + 1, dtype=np.int64)
    rid2 = np.arange(2, n + 2, dtype=np.int64) if is_doubly else np.zeros(n, np.int64)
    uc = np.ones(n, np.int64)
    return build_flat_index_from_entries(
        np.asarray([_pack(k, kw) for k in keys], np.uint32),
        np.asarray([len(k) for k in keys], np.int64),
        rid1, uc, rid2, uc, h, is_doubly)


def large_bucket_index(seed=77):
    """(MergedIndex, int8 reads [48, 100], int32 lengths [48]): twelve
    unique keys share one 26-base prefix, so one bucket holds more than 8
    entries; every read carries one of them (a quarter reverse-complemented)."""
    rng = np.random.default_rng(seed)
    h, kw = 26, 4
    P = list(rng.integers(0, 4, h))
    big = [P + list(t) for t in
           rng.permutation(64)[:12, None] // [16, 4, 1] % 4]
    u_keys = big + [list(rng.integers(0, 4, int(rng.integers(h, 34))))
                    for _ in range(40)]
    d_keys = [list(rng.integers(0, 4, 30)) for _ in range(4)]
    m = build_merged_index(flat_table(u_keys, False, h, kw),
                           flat_table(d_keys, True, h, kw))
    reads = rng.integers(0, 4, size=(48, 100)).astype(np.int8)
    for b in range(48):
        s = big[b % 12] if b % 4 else rc(big[b % 12])
        off = int(rng.integers(0, 100 - len(s)))
        reads[b, off:off + len(s)] = s
    lengths = rng.integers(60, 101, 48).astype(np.int32)
    return m, reads, lengths


def dist_fixture(seed: int = 5):
    """``tests/dist_fixture.py:make_dist_fixture`` with the port's build on
    the CPU (the same index): a 4-genome --both index and 256 reads.
    Returns (BuildArtifacts, ReadSet, number of genome slots)."""
    from cammiq_tpu_torch.index.builder import build_index

    rng = np.random.default_rng(seed)
    length = 400
    shared = rng.integers(0, 4, size=150)
    genomes = []
    for g in range(4):
        own = rng.integers(0, 4, size=length)
        ins = int(rng.integers(0, length - 150))
        seq = np.concatenate([own[:ins], shared, own[ins:]])
        genomes.append([ALPHA[seq].tobytes()])
    corpus = corpus_from_sequences(genomes)
    cfg = BuildConfig(k=12, L=60, Lmax=30, h=12, mode="both")
    art = build_index(corpus, cfg, device="cpu")
    reads = []
    for _ in range(256):
        g = int(rng.integers(0, 4))
        c = genomes[g][0]
        p = int(rng.integers(0, len(c) - 60))
        r = c[p : p + 60]
        if rng.random() < 0.5:
            comp = {65: 84, 67: 71, 71: 67, 84: 65}
            r = bytes(comp[b] for b in reversed(r))
        reads.append(r)
    rs = reads_from_arrays(reads, max_len=64)
    G = int(corpus.ref_id.max()) + 1
    return art, rs, G
