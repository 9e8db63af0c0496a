"""Segmented-scan primitives on the host: a copy of
``cammiq_tpu/ops/scans.py``.

The reference's directional LCP0 sweeps (src/gsa.cpp:239-503) are
sequential run-walks; here they are re-derived as segmented min-scans:
O(n log max_run) fully-vectorized steps (Hillis-Steele with a segment
boundary guard), identical results.  The device build's scans are
``ops/scans.py``.
"""

from __future__ import annotations

import numpy as np


def segment_starts_to_ids(starts: np.ndarray) -> np.ndarray:
    """bool starts [n] -> int64 segment ids [n] (0-based, nondecreasing)."""
    return np.cumsum(starts.astype(np.int64)) - 1


def start_index(starts: np.ndarray) -> np.ndarray:
    """For each i, the index of its segment's first element."""
    n = starts.shape[0]
    idx = np.arange(n, dtype=np.int64)
    return np.maximum.accumulate(np.where(starts, idx, -1))


def end_index(starts: np.ndarray) -> np.ndarray:
    """For each i, the index of its segment's last element."""
    n = starts.shape[0]
    ends = np.empty(n, dtype=bool)
    ends[:-1] = starts[1:]
    ends[-1] = True
    idx = np.arange(n, dtype=np.int64)
    rev = np.minimum.accumulate(np.where(ends, idx, n)[::-1])[::-1]
    return rev


def segmented_cummin(v: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Inclusive forward segmented cumulative min.

    out[i] = min(v[seg_start(i)..i]).  Hillis-Steele doubling with a
    boundary guard; O(n log max_run_len).
    """
    n = v.shape[0]
    out = v.astype(np.int64).copy()
    first = start_index(starts)
    d = 1
    while True:
        idx = np.arange(n, dtype=np.int64)
        ok = idx - d >= first
        if not ok.any():
            break
        prev = out
        cand = np.empty(n, dtype=np.int64)
        cand[d:] = prev[:-d]
        cand[:d] = np.iinfo(np.int64).max
        out = np.where(ok, np.minimum(prev, cand), prev)
        d *= 2
        if d >= n:
            break
    return out


def segmented_cummin_rev(v: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Inclusive backward segmented cumulative min.

    out[i] = min(v[i..seg_end(i)]), where `ends` marks segment last
    elements."""
    return segmented_cummin(v[::-1], ends[::-1])[::-1]
