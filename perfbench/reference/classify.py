"""Counts of a read sample, worked out plainly from the judged index.

CAMMiQ's query loop (``query64_p``/``query64_sc``, ``src/query.cpp:458-1080``):
a read's matches are the entries whose key occurs in the read or in its
reverse complement, each entry once.  Its unique matches name the genomes
``U`` (``rid2 = 0``), its doubly-unique matches the genome pairs ``P``:

- no pair: no genome -> undetermined; one genome -> that genome's unique
  count; more -> conflict;
- pairs and more than one genome -> conflict;
- pairs and one genome that every pair holds -> that genome's unique and
  doubly counts; otherwise conflict;
- one pair and no genome -> both genomes' doubly counts, and the pair's
  count;
- several pairs and no genome -> the one genome every pair holds, its
  doubly count; otherwise conflict.

Every entry a read matched counts that read in its ``rcount`` when the read
is assigned to a genome.  Plain torch on any device, in chunks of reads.
"""

from __future__ import annotations

import numpy as np
import torch

from .index import Matcher, windows


def classify(rows: dict, codes: np.ndarray, num_genome_slots: int, dev,
             chunk: int = 1 << 17, matches_per_batch: int | None = None) -> dict:
    """Counts of int8 [R, L] reads of full length L against ``rows``
    (``index.probe_rows``).  With ``matches_per_batch`` = B, also the
    number of distinct (read, entry) matches in each batch of B reads, how
    many of them belong to assigned reads, and the batch's reads:
    [[matches, assigned, reads], ...]."""
    G = num_genome_slots
    eu, ed = rows["eu"], rows["ed"]
    m = Matcher(rows)
    h, lmax = rows["h"], rows["lmax"]
    R, L = codes.shape
    cnts_u = torch.zeros(G, dtype=torch.int64, device=dev)
    cnts_d = torch.zeros(G, dtype=torch.int64, device=dev)
    rcount = torch.zeros(eu + ed, dtype=torch.int64, device=dev)
    pairs = torch.zeros(G * G, dtype=torch.int64, device=dev)
    nundet = nconf = 0
    per_read_matches = []
    # the rows are indexed by position; map each entry id to its row
    pos = torch.empty(eu + ed, dtype=torch.int64, device=dev)
    pos[rows["orig"]] = torch.arange(rows["orig"].shape[0], device=dev)
    for s in range(0, R, chunk):
        fwd = torch.from_numpy(codes[s:s + chunk]).to(dev)
        n = fwd.shape[0]
        lengths = torch.full((n,), L, device=dev)
        hits = []
        for strand in (fwd, (3 - fwd).flip(1)):
            k0, k1, room = windows(strand, lengths, h, lmax)
            w, row = m.match(k0, k1, room)
            hits.append((w // k0.shape[1]) * (eu + ed) + rows["orig"][row])
        key = torch.unique(torch.cat(hits))          # distinct (read, entry)
        read, ent = key // (eu + ed), key % (eu + ed)
        a1, a2 = rows["rid1"][pos[ent]], rows["rid2"][pos[ent]]
        uni = a2 == 0
        # distinct genomes of the unique matches
        ug = torch.unique(read[uni] * G + a1[uni])
        U = torch.bincount(ug // G, minlength=n)
        urid = torch.zeros(n, dtype=torch.int64, device=dev)
        urid[ug // G] = ug % G
        # distinct pairs of the doubly matches
        lo, hi = torch.minimum(a1, a2)[~uni], torch.maximum(a1, a2)[~uni]
        pk = torch.unique((read[~uni] * G + lo) * G + hi)
        prd, plo, phi = pk // (G * G), (pk // G) % G, pk % G
        P = torch.bincount(prd, minlength=n)
        # pairs that hold the read's one genome
        holds = torch.bincount(prd[(plo == urid[prd]) | (phi == urid[prd])],
                               minlength=n)
        # a genome every pair holds: counted in as many pairs as the read has
        gk, gc = torch.unique(torch.cat([prd * G + plo, prd * G + phi]),
                              return_counts=True)
        every = gc == P[gk // G]
        inter = torch.full((n,), -1, dtype=torch.int64, device=dev)
        inter[(gk // G)[every]] = (gk % G)[every]
        one_pair = torch.zeros(n, dtype=torch.int64, device=dev)
        one_pair[prd] = plo * G + phi            # read with P == 1: its pair

        to_u = ((P == 0) & (U == 1)) | ((P > 0) & (U == 1) & (holds == P))
        to_ud = (P > 0) & (U == 1) & (holds == P)
        to_pair = (P == 1) & (U == 0)
        to_inter = (P > 1) & (U == 0) & (inter >= 0)
        assigned = to_u | to_pair | to_inter
        matched = (U > 0) | (P > 0)
        nundet += int((~matched).sum())
        nconf += int((matched & ~assigned).sum())
        cnts_u.index_add_(0, urid[to_u], torch.ones_like(urid[to_u]))
        cnts_d.index_add_(0, urid[to_ud], torch.ones_like(urid[to_ud]))
        pp = one_pair[to_pair]
        cnts_d.index_add_(0, torch.cat([pp // G, pp % G]),
                          torch.ones(2 * pp.shape[0], dtype=torch.int64, device=dev))
        pairs.index_add_(0, pp, torch.ones_like(pp))
        cnts_d.index_add_(0, inter[to_inter], torch.ones_like(inter[to_inter]))
        take = assigned[read]
        rcount.index_add_(0, ent[take], torch.ones_like(ent[take]))
        if matches_per_batch:
            per_read_matches.append(torch.stack([
                torch.bincount(read, minlength=n),
                torch.bincount(read[take], minlength=n)]))
    out = {"cnts_u": cnts_u.cpu().numpy(), "cnts_d": cnts_d.cpu().numpy(),
           "nundet": nundet, "nconf": nconf,
           "rcount_u": rcount[:eu].cpu().numpy(),
           "rcount_d": rcount[eu:].cpu().numpy()}
    pc = pairs.nonzero().squeeze(1)
    out["pair_counts"] = {(int(k) // G, int(k) % G): int(v) for k, v in
                          zip(pc.tolist(), pairs[pc].tolist())}
    if matches_per_batch:
        per_read = torch.cat(per_read_matches, 1)
        out["matches_per_batch"] = [c.sum(1).tolist() + [c.shape[1]] for c in
                                    per_read.split(matches_per_batch, 1)]
    return out
