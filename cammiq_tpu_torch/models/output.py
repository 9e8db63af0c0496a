"""Result formatting, byte-compatible with the reference output files; a
copy of ``cammiq_tpu/models/output.py``.

- Quantification block (src/query.cpp:1266-1283):
    Query <file>:\nTAXID\tABUNDANCE\tNAME\n<taxid>\t<abund %.6f>\t<name>\n...
  (blank line between files)
- Read-count matrix (outputUniqueCnts / runILPsc, src/query.cpp:1350-1417,
  1786-1818): header "QUERY/TAXID\t<taxids...>" then one row per query
  file with per-species read counts.
"""

from __future__ import annotations

from typing import List, Optional, TextIO

import numpy as np

from ..io.mapfile import GenomeTable


def write_quant_block(
    f: TextIO,
    filename: str,
    table: GenomeTable,
    exist: np.ndarray,
    cov: np.ndarray,
    last_file: bool,
) -> None:
    f.write(f"Query {filename}:\n")
    f.write("TAXID\tABUNDANCE\tNAME\n")
    total = cov[exist].sum()
    for gid in range(1, len(table.genomes)):
        if exist[gid]:
            g = table.genomes[gid]
            ab = cov[gid] / total if total > 0 else 0.0
            f.write(f"{g.taxid}\t{ab:.6f}\t{g.name}\n")
    if not last_file:
        f.write("\n")


def write_counts_header(f: TextIO, table: GenomeTable) -> None:
    f.write("QUERY/TAXID\t")
    n = table.n_species
    for i in range(1, n + 1):
        sep = "\t" if i < n else "\n"
        f.write(f"{table.genomes[i].taxid}{sep}")


def write_counts_row(f: TextIO, filename: str, counts: np.ndarray,
                     n_species: int) -> None:
    f.write(f"{filename}\t")
    for i in range(1, n_species + 1):
        sep = "\t" if i < n_species else "\n"
        f.write(f"{int(counts[i])}{sep}")


def parse_quant_output(path: str) -> List[dict]:
    """Parse quantification blocks back (for tests / comparisons)."""
    out = []
    cur = None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("Query "):
                cur = {"file": line[6:].rstrip(":"), "rows": []}
                out.append(cur)
            elif line and not line.startswith("TAXID") and cur is not None:
                taxid, ab, name = line.split("\t", 2)
                cur["rows"].append((int(taxid), float(ab), name))
    return out
