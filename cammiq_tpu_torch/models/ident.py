"""Identification (Type II / single-cell) ILP: exact branch-and-bound; a
copy of ``cammiq_tpu/models/ident.py``.

Reference (runILPsc_cplex, src/query.cpp:1300-1432):
  minimize sum EXIST subject to
    cnts_u[g] >= unique_read_cnt_thres           -> EXIST[g] = 1
    else if cnts_d[g] < doubly_..._thres         -> EXIST[g] = 0
    for every pair (a,b) with pair count >= doubly_thres touching an
    undetermined genome: EXIST[a] + EXIST[b] >= 1
  then pair counts are redistributed onto the chosen genomes (even split
  with odd-rounding-up when both chosen; src/query.cpp:1390-1409) and the
  per-taxid unique-read-count matrix is emitted.

The undetermined subgraph is tiny in practice, so an exact vertex-cover
branch-and-bound replaces the MIP solver.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..config import IdentFineParams


def solve_ident(
    cnts_u: np.ndarray,
    cnts_d: np.ndarray,
    pair_counts: Dict[Tuple[int, int], int],
    fine: IdentFineParams,
    max_nodes: int = 500_000,
    time_limit: float = 3600.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (exist bool [n], redistributed cnts_u int64 [n]).

    The vertex-cover branch-and-bound is bounded by `max_nodes` expanded
    nodes and `time_limit` seconds (the reference caps its CPLEX solve at
    3600 s, src/query.cpp:1377); when a bound is hit the incumbent is
    completed with the classic maximal-matching 2-approximation (both
    selectable endpoints of each uncovered edge) and a warning is logged -
    the result is then a feasible cover within 2x of optimal."""
    n = cnts_u.shape[0]
    t1, t2 = fine.unique_read_cnt_thres, fine.doubly_unique_read_cnt_thres

    state = np.full(n, 2, np.int8)  # 2 = undetermined
    state[0] = 0
    forced1 = cnts_u >= t1
    forced1[0] = False
    state[forced1] = 1
    forced0 = (~forced1) & (cnts_d < t2)
    forced0[0] = True
    state[forced0] = 0

    # covering constraints: pairs with count >= t2 touching an undetermined
    # genome (the reference adds them per undetermined member,
    # src/query.cpp:1330-1341)
    edges: Set[Tuple[int, int]] = set()
    for (a, b), c in pair_counts.items():
        if c >= t2 and (state[a] == 2 or state[b] == 2):
            edges.add((a, b))

    # drop edges already covered by forced-1 vertices
    open_edges = [(a, b) for (a, b) in edges if state[a] != 1 and state[b] != 1]
    # endpoints forced 0 cannot cover (shown impossible in practice, but be
    # safe): an edge with both endpoints non-selectable is infeasible
    undet = sorted({v for e in open_edges for v in e if state[v] == 2})

    # exact vertex cover over `undet` covering open_edges
    best: Optional[Set[int]] = None

    def feasible_edges() -> List[Tuple[int, int]]:
        out = []
        for a, b in open_edges:
            ca = state[a] == 2
            cb = state[b] == 2
            if not ca and not cb:
                return None  # infeasible edge
            out.append((a, b))
        return out

    checked = feasible_edges()
    if checked is None:
        # reference: CPLEX reports infeasible, no output written
        raise RuntimeError("identification ILP infeasible")

    def greedy_cover(edges_left: List[Tuple[int, int]], chosen: Set[int]) -> Set[int]:
        """Maximal-matching 2-approximation completing `chosen`; edges with
        one selectable endpoint take that endpoint (the exact move)."""
        chosen = set(chosen)
        for a, b in edges_left:
            if a in chosen or b in chosen or state[a] == 1 or state[b] == 1:
                continue
            cands = [v for v in (a, b) if state[v] == 2]
            chosen.update(cands)
        return chosen

    import time as _time

    t0 = _time.perf_counter()
    nodes = 0
    capped = False

    def bnb(edges_left: List[Tuple[int, int]], chosen: Set[int]):
        nonlocal best, nodes, capped
        if capped:
            return
        nodes += 1
        if nodes > max_nodes or (
            nodes % 4096 == 0 and _time.perf_counter() - t0 > time_limit
        ):
            capped = True
            g = greedy_cover(edges_left, chosen)
            if best is None or len(g) < len(best):
                best = g
            return
        if best is not None and len(chosen) >= len(best):
            return
        edges_left = [e for e in edges_left if e[0] not in chosen and e[1] not in chosen]
        if not edges_left:
            if best is None or len(chosen) < len(best):
                best = set(chosen)
            return
        a, b = edges_left[0]
        cands = [v for v in (a, b) if state[v] == 2]
        for v in cands:
            bnb(edges_left, chosen | {v})

    if len(undet) > 900:
        # recursion depth is bounded by the cover size; stay clear of the
        # interpreter stack limit on pathological pair graphs
        capped = True
        best = greedy_cover(checked, set())
    else:
        bnb(checked, set())
    if capped:
        import sys

        print(
            f"[ident] branch-and-bound budget hit ({nodes} nodes, "
            f"{_time.perf_counter() - t0:.1f} s); completed with the "
            f"2-approx greedy cover (size {len(best or set())})",
            file=sys.stderr,
        )
    cover = best or set()

    exist = state == 1
    for v in cover:
        exist[v] = True

    # redistribution (src/query.cpp:1390-1409)
    out_u = cnts_u.astype(np.int64).copy()
    for (a, b), c in pair_counts.items():
        ina, inb = exist[a], exist[b]
        if ina and inb:
            inc = c + (c & 1)
            out_u[a] += inc >> 1
            out_u[b] += inc >> 1
        elif ina:
            out_u[a] += c
        elif inb:
            out_u[b] += c
    return exist, out_u
