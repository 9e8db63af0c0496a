"""Suffix array by prefix doubling on tensors.

Twin of ``cammiq_tpu/ops/sa.py:suffix_array_jax``.  Each round sorts one
int64 key ``rank[i] * (n + 1) + rank[i + k] + 1`` (``rank[i + k] = -1`` past
the end), then re-ranks densely with a ``cumsum`` over the sorted keys.
The JAX engine runs ceil(log2 n) rounds; once every rank is distinct a
round changes nothing (``sa.py:75-76``), so this one stops when the top
rank reaches n - 1 and gives the same array.

``torch.sort`` stands where the JAX engine has ``lax.sort`` (an XLA sort,
not a Pallas kernel).  Each round frees its temporaries before the next
sort: at n = 6e8 one round holds the keys, the sorted keys, the int64
order and the sort's scratch.
"""

from __future__ import annotations

import torch


def suffix_array(s: torch.Tensor) -> torch.Tensor:
    """uint8 text [n] (n < 2^31) -> int32 suffix array [n]."""
    n = s.shape[0]
    dev = s.device
    if n >= 2**31:
        raise ValueError("suffix_array: n must be < 2^31")
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    key = s.to(torch.int64)
    k = 1
    while True:
        key, sa = torch.sort(key)
        brk = key[1:] != key[:-1]
        del key
        dense = torch.zeros(n, dtype=torch.int32, device=dev)
        dense[1:] = torch.cumsum(brk, 0, dtype=torch.int32)
        del brk
        if int(dense[-1]) == n - 1:
            return sa.to(torch.int32)
        rank = torch.empty(n, dtype=torch.int32, device=dev)
        rank[sa] = dense
        del dense, sa
        key = rank.to(torch.int64) * (n + 1)
        key[:max(n - k, 0)] += rank[k:] + 1
        del rank
        k *= 2
