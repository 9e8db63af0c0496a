"""Sharded, streamed merged-index artifact: a copy of
``cammiq_tpu/index/artifact.py`` (save, load, ``ensure_cuckoo``,
``prepare_merged`` and its command,
``python -m cammiq_tpu_torch.index.artifact -i idx_u.npz [idx_d.npz] -o DIR``).

The durable .npz FlatIndex pair (table.py) keeps the reference's two-file
contract (src/hashtrie.cpp:595-699 streams one compact trie per table), but
a production-scale query session then re-derives the RC-augmented, colored,
bucket-sorted MERGED index (query/merged.py:build_merged_index) with
host lexsorts over 2E rows in EVERY process - minutes of redundant work
and multi-GB host copies at 25M+ entries.

This module persists the merged index ONCE at build/prepare time as a
directory of raw .npy arrays + meta.json, so query start is a lazy memmap
load: only the pages a process actually touches (its model shard) are
faulted in, and nothing is re-sorted or re-hashed.

Layout (all arrays little-endian, memmap-able):
  meta.json        format/version, h, kw, eu, ed, max_bucket, n_colors
  erec.npy         uint32 [E, kw+1]  key words + (length|color<<16) fused
  prec.npy         int32  [E, 3]     (gid, rid1, rid2) payloads
  pref_lo.npy      uint32 [NB]       primary bucket hash (sorted)
  pref_hi.npy      uint32 [NB]       secondary bucket hash
  brec.npy         int32  [NB, 2]    bucket (entry start, count)
  bloom.npy        uint32 [2^bloom_log]      probe prefilter (r4+)
  cuckoo.npy       uint32 [2^cuckoo_log, 12] span table (r5+; see
                   merged._build_cuckoo — ensure_cuckoo upgrades older
                   artifacts in place)
  orig_length.npy  int32  [eu+ed]    original-entry-order payloads the
  orig_rid1.npy    int32  [eu+ed]    quant/ident solvers need (rcounts are
  orig_rid2.npy    int32  [eu+ed]    indexed by original entry id)
  orig_ucount1.npy int32  [eu+ed]
  orig_ucount2.npy int32  [eu+ed]

Everything else in a MergedIndex is derived: key_words = erec[:, :kw],
length = erec[:, kw] & 0xFFFF, color = erec[:, kw] >> 16 (lengths are
<= Lmax << 0xFFFF; the NEVER_LEN clamp only affects pad entries), and the
hash-space directory is rebuilt from pref_lo in O(NB).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from ..utils.timing import spanned

FORMAT = "cammiq-tpu-merged"
VERSION = 1


@dataclasses.dataclass
class EntryPayloads:
    """Original-entry-order payload columns of one table - the duck-typed
    subset of FlatIndex that models/quant.py's build_problem reads."""

    h: int
    length: np.ndarray
    rid1: np.ndarray
    rid2: np.ndarray
    ucount1: np.ndarray
    ucount2: np.ndarray

    @property
    def num_entries(self) -> int:
        return int(self.length.shape[0])


def is_merged_artifact(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "meta.json"))


def _write(path: str, arr: np.ndarray) -> None:
    out = np.lib.format.open_memmap(path, mode="w+", dtype=arr.dtype,
                                    shape=arr.shape)
    out[...] = arr
    out.flush()
    del out


def save_merged_artifact(m, index_u, index_d, path: str) -> None:
    """Persist a MergedIndex (+ the original tables' quant payloads) as a
    lazy-loadable directory.  `m` comes from build_merged_index(u, d)."""
    from ..query.merged import _fused_records

    os.makedirs(path, exist_ok=True)
    erec, brec, prec = _fused_records(
        m.key_words, m.length, m.color, m.bucket_start, m.bucket_count,
        m.gid, m.rid1, m.rid2,
    )
    _write(os.path.join(path, "erec.npy"), erec.astype(np.uint32))
    _write(os.path.join(path, "prec.npy"), prec.astype(np.int32))
    _write(os.path.join(path, "pref_lo.npy"), m.pref_lo.astype(np.uint32))
    _write(os.path.join(path, "pref_hi.npy"), m.pref_hi.astype(np.uint32))
    _write(os.path.join(path, "brec.npy"), brec.astype(np.int32))
    # precomputed bloom filter (query/merged.py): sessions memmap it
    # instead of re-deriving from pref_lo at every start
    from ..query.merged import _build_bloom, _build_cuckoo

    bloom, bloom_log = _build_bloom(m.pref_lo.astype(np.uint32))
    _write(os.path.join(path, "bloom.npy"), bloom)
    # precomputed cuckoo span table (r5): the search stage's two-gather
    # replacement for the directory binary search
    ck_tab, ck_log = _build_cuckoo(m.pref_lo, m.bucket_start, m.bucket_count)
    _write(os.path.join(path, "cuckoo.npy"), ck_tab)

    def cat(fu, fd):
        a = fu(index_u) if index_u is not None else np.zeros(0, np.int32)
        b = fd(index_d) if index_d is not None else np.zeros(0, np.int32)
        return np.concatenate([np.asarray(a, np.int32), np.asarray(b, np.int32)])

    for name in ("length", "rid1", "rid2", "ucount1", "ucount2"):
        _write(
            os.path.join(path, f"orig_{name}.npy"),
            cat(lambda i, n=name: getattr(i, n), lambda i, n=name: getattr(i, n)),
        )
    meta = {
        "format": FORMAT, "version": VERSION,
        "h": int(m.h), "kw": int(m.kw), "eu": int(m.eu), "ed": int(m.ed),
        "max_bucket": int(m.max_bucket), "n_colors": int(m.n_colors),
        "E": int(m.length.shape[0]), "NB": int(m.pref_lo.shape[0]),
        "bloom_log": int(bloom_log), "cuckoo_log": int(ck_log),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


@dataclasses.dataclass
class MergedArtifact:
    """Lazy handle over a merged-index directory (arrays are memmaps)."""

    path: str
    h: int
    kw: int
    eu: int
    ed: int
    max_bucket: int
    n_colors: int
    E: int
    NB: int
    erec: np.ndarray       # memmap uint32 [E, kw+1]
    prec: np.ndarray       # memmap int32 [E, 3]
    pref_lo: np.ndarray    # memmap uint32 [NB]
    pref_hi: np.ndarray    # memmap uint32 [NB]
    brec: np.ndarray       # memmap int32 [NB, 2]
    bloom: Optional[np.ndarray] = None   # memmap uint32 [2^bloom_log]
    bloom_log: int = 0
    cuckoo: Optional[np.ndarray] = None  # memmap uint32 [2^cuckoo_log, 12]
    cuckoo_log: int = 0

    @spanned("session.open")
    def payloads(self) -> Tuple[EntryPayloads, Optional[EntryPayloads]]:
        """(unique, doubly-or-None) original-order payload tables."""
        def mm(name):
            return np.load(os.path.join(self.path, f"orig_{name}.npy"),
                           mmap_mode="r")

        cols = {n: mm(n) for n in
                ("length", "rid1", "rid2", "ucount1", "ucount2")}
        u = EntryPayloads(h=self.h, **{k: v[: self.eu] for k, v in cols.items()})
        d = (EntryPayloads(h=self.h,
                           **{k: v[self.eu : self.eu + self.ed]
                              for k, v in cols.items()})
             if self.ed else None)
        return u, d

    def to_merged_index(self):
        """Reconstruct a full (host-view) MergedIndex; slices of memmaps,
        nothing copied until touched."""
        from ..query.merged import MergedIndex, _build_directory

        ds, db, steps = _build_directory(np.asarray(self.pref_lo))
        kw = self.kw
        tail = self.erec[:, kw]
        return MergedIndex(
            h=self.h, kw=kw, eu=self.eu, ed=self.ed,
            max_bucket=self.max_bucket, n_colors=self.n_colors,
            key_words=self.erec[:, :kw],
            length=(tail & np.uint32(0xFFFF)).astype(np.int32),
            rid1=self.prec[:, 1], rid2=self.prec[:, 2],
            gid=self.prec[:, 0],
            color=(tail >> np.uint32(16)).astype(np.int32),
            pref_lo=self.pref_lo, pref_hi=self.pref_hi,
            bucket_start=self.brec[:, 0], bucket_count=self.brec[:, 1],
            dir_start=ds, dir_bits=db, dir_span_steps=steps,
        )


@spanned("session.open")
def load_merged_artifact(path: str) -> MergedArtifact:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a merged-index artifact")
    if meta.get("version", 0) > VERSION:
        raise ValueError(f"{path}: artifact version {meta['version']} is "
                         f"newer than this reader ({VERSION})")

    def mm(name):
        return np.load(os.path.join(path, f"{name}.npy"), mmap_mode="r")

    has_bloom = (meta.get("bloom_log", 0)
                 and os.path.exists(os.path.join(path, "bloom.npy")))
    has_cuckoo = (meta.get("cuckoo_log", 0)
                  and os.path.exists(os.path.join(path, "cuckoo.npy")))
    return MergedArtifact(
        path=path,
        h=meta["h"], kw=meta["kw"], eu=meta["eu"], ed=meta["ed"],
        max_bucket=meta["max_bucket"], n_colors=meta["n_colors"],
        E=meta["E"], NB=meta["NB"],
        erec=mm("erec"), prec=mm("prec"),
        pref_lo=mm("pref_lo"), pref_hi=mm("pref_hi"), brec=mm("brec"),
        bloom=mm("bloom") if has_bloom else None,
        bloom_log=meta.get("bloom_log", 0) if has_bloom else 0,
        cuckoo=mm("cuckoo") if has_cuckoo else None,
        cuckoo_log=meta.get("cuckoo_log", 0) if has_cuckoo else 0,
    )


def ensure_cuckoo(path: str, verbose: bool = False) -> bool:
    """Upgrade a pre-r5 artifact in place: compute + persist the cuckoo
    span table from its bucket arrays.  Returns True if written, False if
    the artifact already had one."""
    import sys
    import time

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("cuckoo_log", 0) and os.path.exists(
            os.path.join(path, "cuckoo.npy")):
        return False
    from ..query.merged import _build_cuckoo

    t0 = time.time()
    pref_lo = np.load(os.path.join(path, "pref_lo.npy"), mmap_mode="r")
    brec = np.load(os.path.join(path, "brec.npy"), mmap_mode="r")
    tab, tlog = _build_cuckoo(np.asarray(pref_lo), brec[:, 0], brec[:, 1])
    _write(os.path.join(path, "cuckoo.npy"), tab)
    meta["cuckoo_log"] = int(tlog)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    if verbose:
        print(f"ensure_cuckoo: {path}: 2^{tlog} rows in "
              f"{time.time() - t0:.1f}s", file=sys.stderr)
    return True


def prepare_merged(fi_u: str, fi_d: Optional[str], out: str,
                   verbose: bool = False) -> None:
    """Build + persist the merged artifact from a FlatIndex .npz pair
    (the offline half of the query-session setup)."""
    import sys
    import time

    from ..query.merged import build_merged_index
    from .table import load_flat_index

    t0 = time.time()
    index_u = load_flat_index(fi_u)
    index_d = load_flat_index(fi_d) if fi_d and os.path.exists(fi_d) else None
    t1 = time.time()
    m = build_merged_index(index_u, index_d)
    t2 = time.time()
    save_merged_artifact(m, index_u, index_d, out)
    # carry the text meta outputs along so the artifact dir is a complete
    # query input (-i MERGED_DIR needs genome_lengths.out etc.)
    import shutil

    src_dir = os.path.dirname(fi_u) or "."
    for fn in ("genome_lengths.out", "unique_lmer_count_u.out",
               "unique_lmer_count_d.out"):
        p = os.path.join(src_dir, fn)
        if os.path.exists(p):
            shutil.copy(p, os.path.join(out, fn))
    if verbose:
        print(
            f"prepare_merged: load {t1 - t0:.1f}s, merge+color+sort "
            f"{t2 - t1:.1f}s, write {time.time() - t2:.1f}s -> {out} "
            f"(E={m.length.shape[0]}, NB={m.pref_lo.shape[0]}, "
            f"max_bucket={m.max_bucket}, n_colors={m.n_colors})",
            file=sys.stderr,
        )


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Precompute the merged query index from a FlatIndex "
        ".npz pair (query sessions then start with a lazy load)")
    ap.add_argument("-i", "--index", nargs="+", required=True,
                    help="idx_u.npz [idx_d.npz]")
    ap.add_argument("-o", "--out", required=True, help="output directory")
    args = ap.parse_args(argv)
    fi_u = args.index[0]
    fi_d = args.index[1] if len(args.index) > 1 else None
    prepare_merged(fi_u, fi_d, args.out, verbose=True)


if __name__ == "__main__":
    main()
