"""Read simulator with ground-truth abundances: a copy of
``cammiq_tpu/tools/simulate.py`` (``python -m cammiq_tpu_torch.tools.simulate``).

Python-3/numpy port of the behavior of the reference's CAMMiQ-simulate
script (Python 2): sample G taxids from the map file, draw reads uniformly
or lognormally across genomes proportional to contig length x abundance,
apply substitution errors at rate e and optional N-rate, reverse-complement
half the reads, and emit FASTQ with provenance headers
('@<gid> c<ci> r<j> rpos<ri> rc<flag> e<pos> X:Y', CAMMiQ-simulate:265-268)
plus true_abundance.out (CAMMiQ-simulate:311-316).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

COMP = {65: 84, 84: 65, 67: 71, 71: 67, 97: 84, 116: 65, 99: 71, 103: 67}
SUBS = {
    "A": "CGT", "C": "AGT", "G": "ACT", "T": "ACG",
}
ALPHABET = "ACGT"


def read_fasta_contigs(path: str, min_len: int) -> List[bytes]:
    out, chunks = [], []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if chunks:
                    c = b"".join(chunks)
                    if len(c) >= min_len:
                        out.append(c)
                    chunks = []
            elif line:
                chunks.append(line)
    if chunks:
        c = b"".join(chunks)
        if len(c) >= min_len:
            out.append(c)
    return out


def rc(read: bytes) -> bytes:
    return bytes(COMP.get(b, b) for b in reversed(read))


def simulate(
    map_file: str,
    db_dir: str,
    output_fq: str,
    report_file: str,
    num_reads: int = 10000,
    L: int = 100,
    L_std: float = 0.0,
    erate: float = 0.0,
    nrate: float = 0.0,
    num_genomes: Optional[int] = None,
    genome_ids: Optional[Sequence[str]] = None,
    dist: str = "uniform",
    seed: int = 0,
) -> Dict[str, float]:
    """Returns {genome id: true abundance} (also written to report_file)."""
    rng = np.random.default_rng(seed)

    # map rows: filename \t gid \t taxid \t name
    rows = []
    with open(map_file) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                rows.append(parts)
    all_ids = []
    for p in rows:
        gid = p[2] if len(p) > 2 else p[1]
        if gid not in all_ids:
            all_ids.append(gid)
    if genome_ids is None:
        if num_genomes is None or num_genomes >= len(all_ids):
            genome_ids = all_ids
        else:
            genome_ids = list(rng.choice(all_ids, size=num_genomes, replace=False))
    genome_ids = [str(g) for g in genome_ids]

    # per selected file: contigs + map id
    contigs: Dict[str, List[bytes]] = {}
    sp_map: Dict[str, str] = {}
    for p in rows:
        gid = p[2] if len(p) > 2 else p[1]
        if str(gid) in genome_ids:
            fn = os.path.join(db_dir, p[0])
            contigs[fn] = read_fasta_contigs(fn, max(L, 1))
            sp_map[fn] = p[1]

    fns = list(contigs.keys())
    abundances = {fn: 1.0 / len(fns) for fn in fns}
    lengths = {fn: [len(c) for c in contigs[fn]] for fn in fns}
    props: Dict[str, List[float]] = {}
    if dist == "uniform":
        suml = float(sum(sum(lengths[fn]) for fn in fns))
        for fn in fns:
            props[fn] = [l / suml for l in lengths[fn]]
    elif dist == "lognormal":
        ab = rng.lognormal(mean=0.0, sigma=1.0, size=len(fns))
        suml = float(sum(sum(lengths[fn]) * ab[j] for j, fn in enumerate(fns)))
        for j, fn in enumerate(fns):
            props[fn] = [l * ab[j] / suml for l in lengths[fn]]
            abundances[fn] = float(ab[j])
        s = float(ab.sum())
        for fn in fns:
            abundances[fn] /= s
    else:
        raise ValueError("dist must be uniform or lognormal")

    with open(output_fq, "w") as fp:
        for fn in fns:
            for ci, contig in enumerate(contigs[fn]):
                Ni = int(math.ceil(num_reads * props[fn][ci]))
                for j in range(Ni):
                    Lr = L
                    if L_std > 0:
                        Lr = int(round(rng.normal(L, L_std)))
                        while Lr <= 50 or Lr > 200:
                            Lr = int(round(rng.normal(L, L_std)))
                    ri = int(rng.integers(0, len(contig) - Lr + 1))
                    read = bytearray(contig[ri : ri + Lr])
                    # resample if non-ACGT present
                    tries = 0
                    while any(b not in (65, 67, 71, 84) for b in read) and tries < 100:
                        ri = int(rng.integers(0, len(contig) - Lr + 1))
                        read = bytearray(contig[ri : ri + Lr])
                        tries += 1
                    rc_flag = 0
                    if rng.random() >= 0.5:
                        read = bytearray(rc(bytes(read)))
                        rc_flag = 1
                    errs = []
                    for l in range(Lr):
                        e = rng.random()
                        if e < erate:
                            orig = chr(read[l])
                            sub = SUBS.get(orig, "ACG")[int(3 * e / erate) % 3]
                            errs.append((l, orig, sub))
                            read[l] = ord(sub)
                    if nrate > 0:
                        for l in range(Lr):
                            if rng.random() < nrate:
                                read[l] = ord("N")
                    hdr = f"@{sp_map[fn]} c{ci} r{j} rpos{ri} rc{rc_flag} "
                    hdr += "".join(f"e{l} {o}:{s} " for l, o, s in errs)
                    fp.write(hdr + "\n")
                    fp.write(read.decode("ascii") + "\n")
                    fp.write("+\n")
                    fp.write("I" * Lr + "\n")

    with open(report_file, "w") as fp:
        for fn in fns:
            fp.write(f"{sp_map[fn]}\t{abundances[fn]:.6f}\n")
    return {sp_map[fn]: abundances[fn] for fn in fns}


def main(argv=None):
    ap = argparse.ArgumentParser(description="CAMMiQ read simulator")
    ap.add_argument("--map", "-f", required=True)
    ap.add_argument("--dir", "-D", required=True)
    ap.add_argument("--out", "-o", required=True)
    ap.add_argument("--report", "-r", required=True)
    ap.add_argument("--num_reads", "-n", type=int, default=10000)
    ap.add_argument("--read_length", "-l", type=int, default=100)
    ap.add_argument("--read_length_std", type=float, default=0.0)
    ap.add_argument("--error_rate", "-e", type=float, default=0.0)
    ap.add_argument("--n_rate", type=float, default=0.0)
    ap.add_argument("--mode", "-m", type=int, default=None,
                    help="number of distinct genome ids to sample")
    ap.add_argument("--genomes", nargs="*", default=None)
    ap.add_argument("--dist", "-d", default="uniform",
                    choices=["uniform", "lognormal"])
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    simulate(
        a.map, a.dir, a.out, a.report,
        num_reads=a.num_reads, L=a.read_length, L_std=a.read_length_std,
        erate=a.error_rate, nrate=a.n_rate, num_genomes=a.mode,
        genome_ids=a.genomes, dist=a.dist, seed=a.seed,
    )


if __name__ == "__main__":
    main()
