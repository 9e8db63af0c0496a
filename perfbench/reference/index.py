"""The index as the plain reference reads it, and its check against the
database.

The reference does not re-derive CAMMiQ's sparsified selection (a greedy
walk over the minimal unique substrings, ``src/build.cpp:336-629``): which
of many valid coverings the build keeps is a choice, and the counts follow
it.  So the reference reads the entries the build chose and judges each one
against the database itself, here: an entry is a substring that occurs in
exactly the genomes its labels name (``rid1`` for a unique entry; ``rid1``
and ``rid2`` for a doubly-unique one, ``rid2 = 0`` marking a unique entry),
on either strand, and its counts (``ucount1``/``ucount2``) are its
occurrences in those genomes, saturated at 255.  A row shorter than the
hash length is not judged: CAMMiQ emits one where a genome's last
unique substring runs into the separator bytes that follow it, so its key
holds bases the genomes do not (``short_rows`` counts them; the probe
compares them as the program does).  The counts of reads are
then worked out from the judged entries (``classify.py``).

The quant prefilter reads each genome's unique L-mer counts, the read
windows of its text that hold a minimal unique (resp. at-most-doubly-unique)
substring.  ``check_index`` bounds them from the database.  Above: the
windows of the genome's two strand copies.  Below, the unique count: the
windows of both copies that hold an occurrence of a judged unique row of
the genome (each occurrence ends where a minimal unique substring no
longer than it ends, so every window holding it is counted); the doubly
count: 1 where a judged row of the doubly table names the genome first
(the build counted that row's windows for it), else 0.
``answers.quant_candidates`` decides the prefilter from the bounds alone.

Entries are read from the files with numpy alone: the ``.npz`` pair
(``key_words`` base t at bits 2(t % 16) of word t // 16) or a merged
artifact directory (``erec.npy`` keys with the length in the low 16 bits
of the last word, ``prec.npy`` (gid, rid1, rid2), ``orig_*.npy`` the
original order's payloads, ``meta.json``).  Keys are re-packed into two
int64 numbers: ``k0`` the first ``h`` bases, ``k1`` the rest (base t at
bits 2t), which ``classify.py`` compares.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

OCC_SATURATE = 255
FIELDS = ("length", "rid1", "rid2", "ucount1", "ucount2")


def _codes_from_words(words: np.ndarray, lmax: int, dev) -> torch.Tensor:
    """int8 [E, lmax] codes of packed uint32 key words (bases past an
    entry's length are whatever the words hold: masked later)."""
    w = torch.from_numpy(words.astype(np.int64)).to(dev)
    t = torch.arange(lmax, device=dev)
    return ((w[:, t // 16] >> (2 * (t % 16))) & 3).to(torch.int8)


def pack(codes: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """int64 [...]: bases ``start .. start + n - 1`` of the last axis,
    base t at bits 2t (n <= 31)."""
    out = torch.zeros(codes.shape[:-1], dtype=torch.int64, device=codes.device)
    for t in range(n):
        out |= codes[..., start + t].to(torch.int64) << (2 * t)
    return out


def length_mask(nbases: torch.Tensor) -> torch.Tensor:
    """int64 mask of the low ``nbases`` bases (2 bits each)."""
    return (torch.ones_like(nbases, dtype=torch.int64) << (2 * nbases)) - 1


def _table(codes, length, rid1, rid2, uc1, uc2, orig, h, dev) -> dict:
    length = torch.as_tensor(np.asarray(length, np.int64), device=dev)
    lmax = codes.shape[1]
    k1 = pack(codes, h, lmax - h) & length_mask((length - h).clamp(min=0))
    return {"k0": pack(codes, 0, h), "k1": k1, "length": length,
            **{k: torch.as_tensor(np.asarray(v, np.int64), device=dev)
               for k, v in (("rid1", rid1), ("rid2", rid2), ("ucount1", uc1),
                            ("ucount2", uc2), ("orig", orig))}}


def load_rows(index_dir: str, lmax: int, dev) -> dict:
    """Every row of the index as the query probes it, with its labels:
    ``orig`` is the entry's id in the original order (unique entries
    first, then doubly ones: ``eu`` tells them apart), the id the
    session's ``rcount_u``/``rcount_d`` are indexed by."""
    meta_path = os.path.join(index_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        h, kw, eu, ed = meta["h"], meta["kw"], meta["eu"], meta["ed"]
        erec = np.load(os.path.join(index_dir, "erec.npy"), mmap_mode="r")
        prec = np.load(os.path.join(index_dir, "prec.npy"))
        orig = {k: np.load(os.path.join(index_dir, f"orig_{k}.npy"))
                for k in FIELDS}
        tail = np.asarray(erec[:, kw])
        gid = prec[:, 0].astype(np.int64)
        rows = _table(_codes_from_words(np.asarray(erec[:, :kw]), lmax, dev),
                      tail & 0xFFFF, prec[:, 1], prec[:, 2],
                      orig["ucount1"][gid], orig["ucount2"][gid], gid, h, dev)
        # the artifact's rows and its original-order payloads must agree
        same = ((orig["length"][gid] == (tail & 0xFFFF))
                & (orig["rid1"][gid] == prec[:, 1])
                & (orig["rid2"][gid] == prec[:, 2]))
        rows["payload_bad"] = int((~same).sum())
        rows["orig_rows"] = np.bincount(gid, minlength=eu + ed)
    else:
        parts, eu, ed = [], 0, 0
        for name in ("index_u.npz", "index_d.npz"):
            z = np.load(os.path.join(index_dir, name))
            h, e = int(z["h"]), int(z["length"].shape[0])
            parts.append(_table(_codes_from_words(z["key_words"], lmax, dev),
                                z["length"], z["rid1"], z["rid2"],
                                z["ucount1"], z["ucount2"],
                                np.arange(e) + eu, h, dev))
            if name == "index_u.npz":
                eu = e
            else:
                ed = e
        rows = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        rows["payload_bad"] = 0
        rows["orig_rows"] = np.ones(eu + ed, np.int64)
    rows.update(h=h, eu=eu, ed=ed, lmax=lmax)
    return rows


def windows(codes: torch.Tensor, lengths: torch.Tensor, h: int, lmax: int):
    """(k0 [R, O], k1 [R, O], room [R, O]) of every offset o < L - h + 1
    of int8 [R, L] code rows: the packed first h bases, the next lmax - h,
    and the bases left in the row from o (``lengths`` - o)."""
    R, L = codes.shape
    O = L - h + 1
    pad = torch.cat([codes, torch.zeros(R, lmax, dtype=codes.dtype,
                                        device=codes.device)], 1)
    k0 = torch.zeros(R, O, dtype=torch.int64, device=codes.device)
    k1 = torch.zeros_like(k0)
    for t in range(h):
        k0 |= pad[:, t:t + O].to(torch.int64) << (2 * t)
    for t in range(lmax - h):
        k1 |= pad[:, h + t:h + t + O].to(torch.int64) << (2 * t)
    room = lengths[:, None].to(torch.int64) - torch.arange(O, device=codes.device)
    return k0, k1, room


class Matcher:
    """Finds, at every window, the rows whose key is a prefix of it."""

    def __init__(self, rows: dict):
        self.rows = rows
        self.order = torch.argsort(rows["k0"])
        self.sorted_k0 = rows["k0"][self.order]

    def match(self, k0, k1, room):
        """(window index, row) of every match among flat windows."""
        k0, k1, room = k0.reshape(-1), k1.reshape(-1), room.reshape(-1)
        lo = torch.searchsorted(self.sorted_k0, k0)
        cnt = torch.searchsorted(self.sorted_k0, k0, right=True) - lo
        win = torch.nonzero(cnt).squeeze(1)
        n = cnt[win]
        w = torch.repeat_interleave(win, n)
        first = torch.cumsum(n, 0) - n
        j = torch.arange(w.shape[0], device=w.device) - torch.repeat_interleave(first, n)
        row = self.order[lo[w] + j]
        rl, h = self.rows["length"][row], self.rows["h"]
        mask = length_mask((rl - h).clamp(min=0))
        ok = (rl <= room[w]) & ((k1[w] & mask) == (self.rows["k1"][row] & mask))
        return w[ok], row[ok]


EDGE = 4    # windows this close to a strand copy's ends are not counted


def window_cover(rowi, start, length, n_rows: int, glen: int, L: int):
    """int64 [n_rows]: the read windows (``L`` bases, at least ``EDGE``
    from either end of a row of ``glen`` bases) of each row that hold one
    of the occurrences (``rowi``, ``start``, ``length``)."""
    dev = rowi.device
    lo = (start + length - L).clamp(min=EDGE)
    hi = start.clamp(max=glen - L - EDGE)
    ok = lo <= hi
    diff = torch.zeros(n_rows, glen + 1, dtype=torch.int32, device=dev)
    flat = diff.view(-1)
    base = rowi[ok] * (glen + 1)
    flat.index_add_(0, base + lo[ok], torch.ones_like(lo[ok], dtype=torch.int32))
    flat.index_add_(0, base + hi[ok] + 1,
                    torch.full_like(hi[ok], -1, dtype=torch.int32))
    return (diff.cumsum(1) > 0).sum(1)


def check_index(rows: dict, genome_codes: torch.Tensor, L: int,
                chunk: int = 32) -> dict:
    """Each row's occurrences in the database, both strands of every
    genome; returns the number of rows whose labels or counts are wrong,
    the index's sizes, and under ``"lmers"`` the bounds of each genome's
    unique L-mer counts (``lmer_bounds``).  ``genome_codes``: int8 [G,
    glen] on the reference's device, genome g having species id g + 1;
    ``L`` the read length the build assumed."""
    m = Matcher(rows)
    h, lmax = rows["h"], rows["lmax"]
    E = rows["k0"].shape[0]
    dev = genome_codes.device
    occ = torch.zeros(3, E, dtype=torch.int64, device=dev)  # rid1, rid2, other
    G, glen = genome_codes.shape
    doubly_table = rows["orig"] >= rows["eu"]
    low = torch.zeros(2, G + 1, dtype=torch.int64, device=dev)
    for g0 in range(0, G, chunk):
        fwd = genome_codes[g0:g0 + chunk]
        nf = fwd.shape[0]
        codes = torch.cat([fwd, (3 - fwd).flip(1)])
        gid = (torch.arange(nf, device=dev) + g0 + 1).repeat(2)
        k0, k1, room = windows(codes, torch.full((codes.shape[0],), glen,
                                                 device=dev), h, lmax)
        w, row = m.match(k0, k1, room)
        ri, off = w // k0.shape[1], w % k0.shape[1]
        g = gid[ri]
        which = torch.where(g == rows["rid1"][row], 0,
                            torch.where(g == rows["rid2"][row], 1, 2))
        occ.view(-1).index_add_(0, which * E + row,
                                torch.ones_like(row))
        # windows of the copies of a unique row's genome that hold it
        sel = (which == 0) & ~doubly_table[row]
        cov = window_cover(ri[sel], off[sel], rows["length"][row[sel]],
                           codes.shape[0], glen, L)
        low[0, g0 + 1:g0 + 1 + nf] = cov[:nf] + cov[nf:]
    sat = occ.clamp(max=OCC_SATURATE)
    doubly = rows["rid2"] != 0
    short = rows["length"] < h
    # a row of the doubly table was counted for its first genome
    low[1] = (torch.bincount(rows["rid1"][doubly_table & ~short],
                             minlength=G + 1)[:G + 1] > 0).to(torch.int64)
    bad = ~short & ((occ[2] > 0) | (occ[0] == 0) | (sat[0] != rows["ucount1"])
                    | (doubly & ((occ[1] == 0) | (sat[1] != rows["ucount2"]))))
    orig_rows = rows["orig_rows"]
    return {"bad_rows": int(bad.sum()) + rows["payload_bad"]
            + int((orig_rows == 0).sum()),
            "rows": E, "short_rows": int(short.sum()), "unique": rows["eu"],
            "doubly": rows["ed"],
            "lmers": lmer_bounds(low.cpu().numpy(), glen)}


def lmer_bounds(low: np.ndarray, glen: int) -> dict:
    """{"nus": (lo, hi), "nds": (lo, hi)}, int64 [G + 1] each (slot 0
    holds 0): a genome's count is at most the windows of its two strand
    copies and their separators."""
    hi = np.full(low.shape[1], 2 * (glen + EDGE), np.int64)
    hi[0] = 0
    return {"nus": (low[0], hi), "nds": (low[1], hi.copy())}


def probe_rows(rows: dict) -> dict:
    """One row an original entry (the lowest), for a probe of both strands:
    a merged artifact holds an entry's key and its reverse complement,
    which a probe of both strands would count twice."""
    orig = rows["orig"]
    E = rows["eu"] + rows["ed"]
    first = torch.full((E,), orig.shape[0], dtype=torch.int64, device=orig.device)
    first.scatter_reduce_(0, orig, torch.arange(orig.shape[0], device=orig.device),
                          "amin")
    first = first[first < orig.shape[0]]
    return {k: (v[first] if isinstance(v, torch.Tensor) else v)
            for k, v in rows.items()}
