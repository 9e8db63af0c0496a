"""Host LCP arrays: copies of ``cammiq_tpu/ops/lcp.py`` (1-88).

``lcp_from_sa_numpy`` (vectorised pairwise extension, the numpy build
engine's LCP) and ``lcp_kasai_scalar`` (plain Kasai, the tests' oracle).
Convention (the reference's): LCP[i] = lcp(suffix SA[i-1], suffix SA[i]),
LCP[0] = 0, plus a trailing LCP[n] = 0 slot; values clamp at
``LCP_CLAMP`` (src/gsa.cpp:158).  The device engine's LCP is
``kernels/lcp_pairs.py``.
"""

from __future__ import annotations

import numpy as np

LCP_CLAMP = 0xFFFF  # reference clamps LCP to uint16 (src/gsa.cpp:158)


def lcp_from_sa_numpy(s: np.ndarray, sa: np.ndarray, clamp: int = LCP_CLAMP) -> np.ndarray:
    """LCP array via vectorized pairwise extension.

    Returns int64 [n+1] with LCP[0] = LCP[n] = 0.
    """
    s = np.asarray(s)
    sa = np.asarray(sa, dtype=np.int64)
    n = s.shape[0]
    lcp = np.zeros(n + 1, dtype=np.int64)
    if n <= 1:
        return lcp
    a = sa[1:]      # suffix starts
    b = sa[:-1]     # preceding suffix starts
    # Batched extension: compare growing blocks until mismatch; pad the two
    # streams with distinct sentinels so out-of-range positions mismatch.
    cur = np.zeros(n - 1, dtype=np.int64)
    active = np.arange(n - 1)
    block = 32
    maxblock = 1 << 14
    sp_a = np.concatenate([s, np.full(maxblock, 255, dtype=np.uint8)])
    sp_b = np.concatenate([s, np.full(maxblock, 254, dtype=np.uint8)])
    while active.size:
        offs = np.arange(block)
        ia = a[active, None] + cur[active, None] + offs[None, :]
        ib = b[active, None] + cur[active, None] + offs[None, :]
        va = sp_a[np.minimum(ia, n + maxblock - 1)]
        vb = sp_b[np.minimum(ib, n + maxblock - 1)]
        # mark out-of-range as mismatching sentinels
        va = np.where(ia < n, va, 255)
        vb = np.where(ib < n, vb, 254)
        eq = va == vb
        run = np.cumprod(eq, axis=1).sum(axis=1)
        cur[active] += run
        keep = (run == block) & (cur[active] < clamp)
        active = active[keep]
        block = min(block * 4, maxblock)
    lcp[1:n] = np.minimum(cur, clamp)
    return lcp


def lcp_kasai_scalar(s: np.ndarray, sa: np.ndarray, clamp: int = LCP_CLAMP) -> np.ndarray:
    """Plain scalar Kasai (oracle for tests; O(n) but Python-slow)."""
    s = np.asarray(s)
    n = s.shape[0]
    rank = np.empty(n, dtype=np.int64)
    rank[np.asarray(sa, dtype=np.int64)] = np.arange(n)
    lcp = np.zeros(n + 1, dtype=np.int64)
    h = 0
    for i in range(n):
        k = rank[i]
        if k == 0:
            h = 0
            continue
        j = sa[k - 1]
        while i + h < n and j + h < n and s[i + h] == s[j + h]:
            h += 1
        lcp[k] = min(h, clamp)
        if h > 0:
            h -= 1
    return lcp
