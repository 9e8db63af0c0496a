"""Hand-made merged indexes for the port's tests (no JAX imported, so the
card-only tests can use them on a host without jax)."""

from __future__ import annotations

import numpy as np

from cammiq_tpu.index.table import build_flat_index_from_entries
from cammiq_tpu.query.sortjoin import build_merged_index


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
