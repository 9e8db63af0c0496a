"""RefSeq genome downloader (port of the reference CAMMiQ-download
Python-2 script to Python 3): a copy of ``cammiq_tpu/tools/download.py``
(``python -m cammiq_tpu_torch.tools.download``).

Pulls assembly_summary.txt for the requested divisions (bacteria, viral,
archaea), keeps "Complete Genome" assemblies, optionally dedups per
taxid/species preferring reference/representative genomes, downloads each
genome's *_genomic.fna.gz, and writes genome_map.out with 1..n genome ids
grouped by taxid (reference: CAMMiQ-download:89-222).

Network access is required; in offline environments use --summary to
point at pre-downloaded assembly_summary.txt files and --no-fetch to only
regenerate the map.
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys
import urllib.request
from typing import Dict, List, Optional, Tuple

NCBI_BASE = "https://ftp.ncbi.nlm.nih.gov/genomes/refseq"

DIVISIONS = ("bacteria", "viral", "archaea")


def fetch_summary(division: str, dest: str) -> str:
    url = f"{NCBI_BASE}/{division}/assembly_summary.txt"
    path = os.path.join(dest, f"assembly_summary_{division}.txt")
    if not os.path.exists(path):
        urllib.request.urlretrieve(url, path)
    return path


def parse_assembly_summary(path: str, complete_only: bool = True,
                           dedup: bool = True) -> List[dict]:
    """Rows: assembly_accession, taxid, species_taxid, organism_name,
    ftp_path, refseq_category."""
    rows = []
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith("#"):
                continue
            p = line.rstrip("\n").split("\t")
            if len(p) < 20:
                continue
            level = p[11]
            if complete_only and level != "Complete Genome":
                continue
            rows.append({
                "accession": p[0],
                "refseq_category": p[4],
                "taxid": p[5],
                "species_taxid": p[6],
                "name": p[7],
                "ftp_path": p[19],
            })
    if dedup:
        # prefer reference genome > representative genome > first seen
        rank = {"reference genome": 0, "representative genome": 1}
        best: Dict[str, dict] = {}
        for r in rows:
            key = r["species_taxid"]
            score = rank.get(r["refseq_category"], 2)
            if key not in best or score < rank.get(best[key]["refseq_category"], 2):
                best[key] = r
        rows = list(best.values())
    return rows


def genome_filename(row: dict) -> str:
    base = row["ftp_path"].rsplit("/", 1)[-1]
    return f"{base}_genomic.fna"


def download_genomes(rows: List[dict], outdir: str, decompress: bool = True) -> None:
    os.makedirs(outdir, exist_ok=True)
    for r in rows:
        base = r["ftp_path"].rsplit("/", 1)[-1]
        url = f"{r['ftp_path']}/{base}_genomic.fna.gz"
        gz = os.path.join(outdir, f"{base}_genomic.fna.gz")
        fna = os.path.join(outdir, f"{base}_genomic.fna")
        if os.path.exists(fna):
            continue
        print(f"fetching {url}", file=sys.stderr)
        urllib.request.urlretrieve(url, gz)
        if decompress:
            with gzip.open(gz, "rb") as fi, open(fna, "wb") as fo:
                fo.write(fi.read())
            os.remove(gz)


def write_map(rows: List[dict], path: str) -> None:
    """genome_map.out: filename \t gid \t taxid \t name, 1..n ids grouped
    by taxid (files sharing a taxid share a gid, reference
    CAMMiQ-download:209-222)."""
    by_taxid: Dict[str, int] = {}
    next_id = 1
    with open(path, "w") as f:
        for r in sorted(rows, key=lambda x: (int(x["species_taxid"]), x["accession"])):
            t = r["species_taxid"]
            if t not in by_taxid:
                by_taxid[t] = next_id
                next_id += 1
            f.write(f"{genome_filename(r)}\t{by_taxid[t]}\t{t}\t{r['name']}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description="CAMMiQ RefSeq downloader")
    ap.add_argument("--divisions", "-d", nargs="+", default=["bacteria"],
                    choices=list(DIVISIONS))
    ap.add_argument("--out", "-o", default="./genomes")
    ap.add_argument("--map", "-m", default="./genome_map.out")
    ap.add_argument("--summary", nargs="*", default=None,
                    help="pre-downloaded assembly_summary.txt files")
    ap.add_argument("--no-dedup", action="store_true")
    ap.add_argument("--all-levels", action="store_true",
                    help="keep non-complete assemblies too")
    ap.add_argument("--no-fetch", action="store_true",
                    help="only write the map file")
    a = ap.parse_args(argv)

    os.makedirs(a.out, exist_ok=True)
    rows: List[dict] = []
    if a.summary:
        for p in a.summary:
            rows += parse_assembly_summary(p, not a.all_levels, not a.no_dedup)
    else:
        for d in a.divisions:
            p = fetch_summary(d, a.out)
            rows += parse_assembly_summary(p, not a.all_levels, not a.no_dedup)
    write_map(rows, a.map)
    if not a.no_fetch:
        download_genomes(rows, a.out)


if __name__ == "__main__":
    main()
