"""Host suffix array: copies of ``cammiq_tpu/ops/sa.py`` (23-66).

``suffix_array_numpy`` (prefix doubling with numpy, the numpy build
engine's sort and the oracle of the native sorts) and
``inverse_permutation``.  The device engine's sort is ``ops/sa.py``.
"""

from __future__ import annotations

import numpy as np


def suffix_array_numpy(s: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array (Manber-Myers / Larsson-Sadakane style).

    s: uint8 array.  Returns int64 [n] suffix array.
    """
    s = np.asarray(s)
    n = s.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    # initial ranks = byte values
    rank = s.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    rank = rank[sa]
    # convert sorted byte values to dense ranks over sa order
    r = np.empty(n, dtype=np.int64)
    r[sa] = np.cumsum(np.concatenate([[0], (np.diff(rank) != 0).astype(np.int64)]))
    rank = r
    k = 1
    while k < n:
        # key = (rank[i], rank[i+k]) with rank[i+k] = -1 past the end
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        key1 = rank[order]
        key2 = rank2[order]
        changed = np.concatenate(
            [[0], ((np.diff(key1) != 0) | (np.diff(key2) != 0)).astype(np.int64)]
        )
        newrank = np.cumsum(changed)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = newrank
        sa = order
        if newrank[-1] == n - 1:
            break
        k *= 2
    return sa.astype(np.int64)


def inverse_permutation(sa: np.ndarray) -> np.ndarray:
    """REV[SA[i]] = i (reference computeRevSuffixArray, src/gsa.cpp:39-58)."""
    sa = np.asarray(sa)
    rev = np.empty_like(sa)
    rev[sa] = np.arange(sa.shape[0], dtype=sa.dtype)
    return rev
