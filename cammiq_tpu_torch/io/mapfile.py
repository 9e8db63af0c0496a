"""Genome metadata: map file + meta outputs; a copy of ``cammiq_tpu/io/mapfile.py``.

Reference: loadSmap (src/query.cpp:125-156) and loadGenomeLength
(src/query.cpp:158-205).  The map file has tab-separated lines
  <fasta filename> \t <genome id> \t <taxid> \t <name>
with 1-based genome (species) ids; lines repeating a taxid merge their
names ('/'-joined) onto the existing genome.  Meta files are
"<id>\t<value>" lines; repeated ids overwrite (last wins), matching the
reference's per-file writes being re-read per species.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Genome:
    taxid: int
    name: str
    glength: int = 0
    nus: int = 0
    nds: int = 0


@dataclasses.dataclass
class GenomeTable:
    """genomes[1..n_species]; index 0 unused (reference keeps genomes[0]
    = NULL)."""

    genomes: List[Optional[Genome]]

    @property
    def n_species(self) -> int:
        return len(self.genomes) - 1

    def taxids(self) -> np.ndarray:
        return np.asarray([g.taxid for g in self.genomes[1:]], dtype=np.int64)

    def arrays(self):
        """(glength, nus, nds) int64 [n_species+1] (slot 0 zero)."""
        n = len(self.genomes)
        gl = np.zeros(n, dtype=np.int64)
        nus = np.zeros(n, dtype=np.int64)
        nds = np.zeros(n, dtype=np.int64)
        for i, g in enumerate(self.genomes):
            if g is not None:
                gl[i], nus[i], nds[i] = g.glength, g.nus, g.nds
        return gl, nus, nds


def load_smap(map_path: str) -> GenomeTable:
    genomes: List[Optional[Genome]] = [None]
    seen_taxids = set()
    with open(map_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 4:
                raise ValueError(f"bad map line: {line!r}")
            _fname, gid, taxid, name = parts[0], int(parts[1]), int(parts[2]), parts[3]
            if taxid in seen_taxids:
                g = genomes[gid]
                if g is not None:
                    g.name += "/" + name
            else:
                genomes.append(Genome(taxid=taxid, name=name))
                seen_taxids.add(taxid)
    return GenomeTable(genomes)


def load_genome_lengths(table: GenomeTable, idx_dir: str,
                        require_doubly: bool = True) -> None:
    """Populate glength/nus/nds from the meta outputs (last line wins per
    id, like the reference)."""

    def load(fn: str, attr: str, required: bool) -> None:
        path = os.path.join(idx_dir, fn)
        if not os.path.exists(path):
            if required:
                raise FileNotFoundError(path)
            return
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                gid, val = int(parts[0]), int(parts[1])
                if 1 <= gid < len(table.genomes) and table.genomes[gid] is not None:
                    setattr(table.genomes[gid], attr, val)

    load("genome_lengths.out", "glength", True)
    load("unique_lmer_count_u.out", "nus", True)
    load("unique_lmer_count_d.out", "nds", require_doubly)
