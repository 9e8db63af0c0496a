"""OCC neighbour walks: plain PyTorch versions + CUDA kernel wrapper.

Replace the while-loops of ``cammiq_tpu/index/unique_jax.py``:
``_adjacent_count_jax`` as ``occ_unique_jax`` calls it (132-176) and the
walks of ``occ_doubly_jax`` (179-226).  Both return rank-order counts,
already saturated at 255; ``index/unique.py`` scatters them to text order.

    occ_count_unique: occ[i] = min(1 + up + down, 255), where up/down count
        the steps d <= 255 from rank i, in each direction, before the first
        one whose neighbour is of another genome or whose running min of
        the crossing LCP is <= lcp0[i].
    occ_count_doubly: for ranks with lcp0[i] <= ulmax and i > end_excl
        (others 0), walks of d <= 511 through neighbours of genome gsa[i]
        or g2[i], the downward one no further than end_excl; occ counts
        the own-genome steps (+1), occ2 the g2 steps.

Kernel: ``csrc/occ_count.cu`` (one thread per rank; see the source note).
Both walks share one C entry point and one launch counter.
"""

from __future__ import annotations

import torch

from .build import I32, I64, VP, CudaKernel, check_tensor, stream_ptr

OCC_SATURATE = 255  # cammiq_tpu/index/unique.py:OCC_SATURATE

KERNEL = CudaKernel("cammiq_occ_count", [VP, VP, VP, VP, I64, I64, I32, VP, VP, VP])

_BIG = 2**31 - 1


def _walk(lcp, lcp0, gsa, g2, live, sign, max_steps, bound):
    """One direction of the walk for the ranks in ``live`` (int64), as the
    JAX loop runs it, compacting the live set after every step.  Returns
    (own-genome, g2) step counts, int32 [n]; with ``g2`` None only the
    first is counted (the unique walk)."""
    n = gsa.shape[0]
    c1 = torch.zeros(n, dtype=torch.int32, device=gsa.device)
    c2 = torch.zeros_like(c1)
    rm = torch.full_like(live, _BIG, dtype=torch.int32)
    for d in range(1, max_steps + 1):
        if not live.numel():
            break
        j = live + sign * d
        ok = (j <= n - 1) if sign > 0 else (j >= bound)
        gj = gsa[j.clamp(0, n - 1)]
        g = gsa[live]
        own = gj == g
        if g2 is None:
            other = torch.zeros_like(own)
        else:
            other = gj == g2[live]
            ok &= own | other
        cross = lcp[(live + d) if sign > 0 else (live - d + 1)]
        rm = torch.where(ok, torch.minimum(rm, cross), rm)
        ok &= rm > lcp0[live]
        if g2 is None:
            ok &= own
        live, rm, own, other = live[ok], rm[ok], own[ok], other[ok]
        c1.index_add_(0, live, own.to(torch.int32))
        c2.index_add_(0, live, other.to(torch.int32))
    return c1, c2


def occ_count_unique_plain(lcp: torch.Tensor, lcp0: torch.Tensor,
                           gsa: torch.Tensor) -> torch.Tensor:
    n = gsa.shape[0]
    every = torch.arange(n, device=gsa.device)
    up, _ = _walk(lcp, lcp0, gsa, None, every, 1, OCC_SATURATE, 0)
    down, _ = _walk(lcp, lcp0, gsa, None, every, -1, OCC_SATURATE, 0)
    return (1 + up + down).clamp_(max=OCC_SATURATE)


def occ_count_doubly_plain(lcp: torch.Tensor, lcp0: torch.Tensor,
                           gsa: torch.Tensor, g2: torch.Tensor, ulmax: int,
                           end_excl: int):
    n = gsa.shape[0]
    idx = torch.arange(n, device=gsa.device)
    processed = (lcp0 <= ulmax) & (idx > end_excl)
    live = idx[processed]
    steps = 2 * OCC_SATURATE + 1
    u1, u2 = _walk(lcp, lcp0, gsa, g2, live, 1, steps, 0)
    d1, d2 = _walk(lcp, lcp0, gsa, g2, live, -1, steps, end_excl)
    occ = torch.where(processed, (1 + u1 + d1).clamp_(max=OCC_SATURATE), 0)
    occ2 = torch.where(processed, (u2 + d2).clamp_(max=OCC_SATURATE), 0)
    return occ.to(torch.int32), occ2.to(torch.int32)


def _check(lcp, lcp0, gsa, g2=None):
    dev = gsa.device
    if dev.type != "cuda":
        raise ValueError(f"occ_count: unsupported device {dev}")
    n = gsa.shape[0]
    for name, t, size in (("lcp", lcp, n + 1), ("lcp0", lcp0, n),
                          ("gsa", gsa, n), ("g2", g2, n)):
        if t is None:
            continue
        check_tensor(t, name, torch.int32, dev, 1)
        if t.shape[0] != size:
            raise ValueError(f"{name}: length {t.shape[0]}, expected {size}")
    if n >= 2**31:
        raise ValueError("occ_count: n must be < 2^31")
    return dev, n


def occ_count_unique(lcp: torch.Tensor, lcp0: torch.Tensor,
                     gsa: torch.Tensor) -> torch.Tensor:
    """int32 lcp [n+1], lcp0 [n], gsa [n] -> int32 occ [n], rank order.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if gsa.device.type == "cpu":
        return occ_count_unique_plain(lcp, lcp0, gsa)
    dev, n = _check(lcp, lcp0, gsa)
    occ = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        KERNEL(lcp.data_ptr(), lcp0.data_ptr(), gsa.data_ptr(), None, n, 0, 0,
               occ.data_ptr(), None, stream_ptr(dev))
    return occ


def occ_count_doubly(lcp: torch.Tensor, lcp0: torch.Tensor, gsa: torch.Tensor,
                     g2: torch.Tensor, ulmax: int, end_excl: int):
    """int32 lcp [n+1], lcp0/gsa/g2 [n] (g2: second genome per rank) ->
    (occ, occ2) int32 [n], rank order.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if gsa.device.type == "cpu":
        return occ_count_doubly_plain(lcp, lcp0, gsa, g2, ulmax, end_excl)
    dev, n = _check(lcp, lcp0, gsa, g2)
    if not 0 <= end_excl < max(n, 1) or not 0 <= ulmax < 2**31:
        raise ValueError(f"occ_count: end_excl {end_excl}, ulmax {ulmax}")
    occ = torch.empty(n, dtype=torch.int32, device=dev)
    occ2 = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        KERNEL(lcp.data_ptr(), lcp0.data_ptr(), gsa.data_ptr(), g2.data_ptr(),
               n, end_excl, ulmax, occ.data_ptr(), occ2.data_ptr(),
               stream_ptr(dev))
    return occ, occ2
