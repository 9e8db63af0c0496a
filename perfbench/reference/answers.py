"""The solvers' answers, judged against the reference's.

Quantification (``src/query.cpp:1082-1298``): a genome is a candidate of
the MIQP only when both its unique and its doubly-unique read counts pass
the prefilter (``src/query.cpp:1100-1133``: at least ``read_cnt_thres`` when
its unique L-mer count reaches ``easy_to_identify_thres``, and at least
``ilp_alpha`` times its unique, resp. doubly-unique, L-mer count); the
MIQP over them is ``quant.py``'s.  The program's output block is judged
row by row against the reference's answer.

Identification (Type II, ``runILPsc``, ``src/query.cpp:1300-1432``): a
genome with ``unique_read_cnt_thres`` unique reads exists; one with fewer
and under ``doubly_unique_read_cnt_thres`` doubly reads does not; every
pair counted at least ``doubly_unique_read_cnt_thres`` times that touches an
undecided genome needs one of its genomes; the fewest undecided genomes
that cover those pairs exist.  Several covers may be fewest, so the
program's answer is judged, not matched: it must keep the forced
decisions, cover every such pair, be no larger than the reference's
smallest cover, and its counts must be the program's EXIST's
redistribution of the pair counts (an even split rounded up, both chosen;
all to the one chosen).
"""

from __future__ import annotations


import numpy as np


class Undecided(ValueError):
    """The L-mer count bounds leave a prefilter decision open."""


def _decide(ok_lo, ok_hi, what: str) -> np.ndarray:
    """A test of a count taken at both ends of its bounds: decided where
    both ends agree."""
    open_ = np.nonzero(ok_lo != ok_hi)[0]
    if open_.size:
        raise Undecided(f"{what}: genomes {open_.tolist()[:10]} lie between "
                        "their L-mer count bounds")
    return ok_lo


def quant_candidates(cnts_u, cnts_d, lmers: dict, read_cnt_thres=100,
                     easy_thres=10000, alpha=1e-4) -> tuple:
    """(keep bool [n], easy bool [n]): the genomes the prefilter keeps
    (slot 0 never), and those whose unique L-mer count reaches
    ``easy_thres``.  ``lmers`` holds the (low, high) bounds of each genome's
    unique and doubly L-mer counts (``index.lmer_bounds``); a decision that
    differs between the ends raises ``Undecided``."""
    (us_lo, us_hi), (ds_lo, ds_hi) = lmers["nus"], lmers["nds"]
    easy = _decide(us_lo >= easy_thres, us_hi >= easy_thres, "easy")

    def passes(cnt, lmers):
        ok = cnt >= lmers * alpha
        return np.where(easy, ok & (cnt >= read_cnt_thres), ok)

    cu, cd = np.asarray(cnts_u), np.asarray(cnts_d)
    # each test holds at the low end of its count first
    keep = _decide(passes(cu, us_hi) & passes(cd, ds_hi),
                   passes(cu, us_lo) & passes(cd, ds_lo), "prefilter")
    keep[0] = False
    return keep, easy


def judge_quant(exist_ref, ab_ref, name: str, exist, text: str) -> dict:
    """Numbers of the program's quant answer against the reference's
    (``quant.solve``): genomes whose EXIST differs; lines of the output
    block that are not its header or a row ``<taxid> <abundance> g<taxid>``
    of a genome the reference chose, and rows missing; and the L1 distance
    of the abundances the block prints from the reference's."""
    lines = text.splitlines()
    bad = int(lines[:2] != [f"Query {name}:", "TAXID\tABUNDANCE\tNAME"])
    ab = np.zeros(len(ab_ref))
    seen = set()
    for line in lines[2:]:
        p = line.split("\t")
        gid = int(p[0]) if len(p) == 3 and p[0].isdigit() else 0
        if 0 < gid < len(ab) and p[2] == f"g{gid}" and exist_ref[gid] and gid not in seen:
            ab[gid] = float(p[1])
            seen.add(gid)
        else:
            bad += 1
    bad += int(np.count_nonzero(exist_ref)) - len(seen)
    return {"exist_diff": int((np.asarray(exist, bool) != exist_ref).sum()),
            "lines_diff": bad, "abund_l1": float(np.abs(ab - ab_ref).sum())}


def _min_cover(edges, free) -> int:
    """Size of the smallest set of ``free`` vertices covering ``edges``
    (each edge has a free endpoint), by branching on an uncovered edge."""
    best = [len(free)]

    def go(left, size):
        if size >= best[0]:
            return
        if not left:
            best[0] = size
            return
        a, b = left[0]
        for v in (a, b):
            if v in free:
                go([e for e in left if v not in e], size + 1)

    go(list(edges), 0)
    return best[0]


def judge_ident(ref: dict, exist, redist, t1=10, t2=5) -> dict:
    """Violations of the Type-II answer: forced decisions broken, pairs
    left uncovered, a cover larger than the smallest, and redistributed
    counts that differ from the rule applied to the program's EXIST."""
    cu, cd = np.asarray(ref["cnts_u"]), np.asarray(ref["cnts_d"])
    n = cu.shape[0]
    exist = np.asarray(exist, bool)
    ones = cu >= t1
    ones[0] = False
    zeros = ~ones & (cd < t2)
    zeros[0] = True
    free = set(np.nonzero(~ones & ~zeros)[0].tolist())
    edges = [(a, b) for (a, b), c in ref["pair_counts"].items()
             if c >= t2 and (a in free or b in free)
             and not (ones[a] or ones[b])]
    bad = int((exist & zeros).sum() + (~exist & ones).sum())
    bad += sum(not (exist[a] or exist[b]) for a, b in edges)
    chosen = int(sum(exist[v] for v in free))
    bad += int(chosen > _min_cover(edges, free))
    want = cu.astype(np.int64).copy()
    for (a, b), c in ref["pair_counts"].items():
        if exist[a] and exist[b]:
            want[a] += (c + (c & 1)) >> 1
            want[b] += (c + (c & 1)) >> 1
        elif exist[a]:
            want[a] += c
        elif exist[b]:
            want[b] += c
    bad += int((np.asarray(redist, np.int64)[:n] != want).sum())
    return {"ident_bad": bad, "undecided": len(free), "pairs_to_cover": len(edges)}
