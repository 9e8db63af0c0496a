"""FASTA ingestion and corpus assembly: a copy of ``cammiq_tpu/io/fasta.py``,
the streaming corpus of the cross-host build (``build_corpus_streaming``,
191-246) included.

Reproduces the reference corpus layout exactly (src/build.cpp:124-266):

- For every FASTA file (one genome each), for every contig:
    * contig bases are appended as ASCII + 165 (mod 256) bytes;
    * a 4-byte separator encoding the 28-bit contig counter in big-endian
      7-bit chunks (values 0..127) is appended (src/build.cpp:218-239);
    * the reverse complement of the contig is appended as a sibling contig
      with its own separator (src/build.cpp:241-266).
- contig_pos[c] = corpus position one past contig c's separator
  (src/build.cpp:231); ref_pos[g] = corpus position at the end of genome g
  (src/build.cpp:165).
- refID[g] = the genome id from the map file (multiple files may share one
  id; ids are 1-based species ids) (src/build.cpp:100-122).

The corpus is a single numpy uint8 array; downstream (suffix array etc.)
appends two 0 sentinels (src/build.cpp:280-281).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple

import numpy as np

from ..config import MAX_C, MAX_M, MAX_N
from ..ops.packing import BASE_OFFSET, RC_IDX

FASTA_EXTS = (".fasta", ".fna", ".ffn")  # reference: src/build.cpp:66-75


@dataclasses.dataclass
class Corpus:
    """The concatenated genome text plus its position tables."""

    seq: np.ndarray                 # uint8 [N] (no sentinels)
    contig_pos: np.ndarray          # uint64 [C] end positions (past separator)
    ref_pos: np.ndarray             # uint64 [M] end positions per genome file
    ref_id: np.ndarray              # uint32 [M] genome (species) id per file
    filenames: List[str]

    @property
    def n(self) -> int:
        return int(self.seq.shape[0])

    @property
    def num_files(self) -> int:
        return int(self.ref_pos.shape[0])

    @property
    def num_contigs(self) -> int:
        return int(self.contig_pos.shape[0])

    def with_sentinels(self) -> np.ndarray:
        """seq + two 0 sentinel bytes (src/build.cpp:280-281)."""
        return np.concatenate([self.seq, np.zeros(2, dtype=np.uint8)])

    def genome_lengths(self) -> np.ndarray:
        """Per-file genome length = sum of contig base lengths / 2.

        Halved because the RC of every contig is stored as a sibling contig
        (reference: src/build.cpp:682-697).
        """
        cp = self.contig_pos.astype(np.int64)
        starts = np.concatenate([[0], cp[:-1]])
        clen = cp - starts - 4  # minus the 4-byte separator
        out = np.zeros(self.num_files, dtype=np.int64)
        j = 0
        acc = 0
        rp = self.ref_pos.astype(np.int64)
        for c in range(len(cp)):
            acc += clen[c]
            if cp[c] >= rp[j]:
                out[j] = acc // 2
                j += 1
                acc = 0
        return out


def _contig_separator(contig_counter: int) -> np.ndarray:
    """4 bytes, big-endian 7-bit chunks of the contig counter
    (src/build.cpp:218-239)."""
    return np.array(
        [(contig_counter >> (7 * i)) & 0x7F for i in (3, 2, 1, 0)],
        dtype=np.uint8,
    )


def _parse_fasta_contigs(path: str) -> List[np.ndarray]:
    """Contigs of one FASTA file as raw ASCII uint8 arrays."""
    contigs: List[np.ndarray] = []
    chunks: List[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if chunks:
                    contigs.append(np.frombuffer(b"".join(chunks), dtype=np.uint8))
                    chunks = []
            elif line:
                chunks.append(line)
    if chunks:
        contigs.append(np.frombuffer(b"".join(chunks), dtype=np.uint8))
    return contigs


def read_map_file(map_path: str, indir: str = "") -> List[Tuple[str, int]]:
    """Map file: '<filename>\\t<genome id>[\\t taxid \\t name]' lines
    (reference readFnMap, src/build.cpp:100-122).  Returns (path, id) in
    file order."""
    out: List[Tuple[str, int]] = []
    with open(map_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            fn, sp = parts[0], int(parts[1])
            out.append((os.path.join(indir, fn) if indir else fn, sp))
    return out


def list_fasta_dir(indir: str) -> List[Tuple[str, int]]:
    """Directory scan fallback (reference prepFasta, src/build.cpp:56-84);
    every file gets genome id 0 (the reference leaves ids 0 without a map)."""
    out = []
    for fn in sorted(os.listdir(indir)):
        if fn.endswith(FASTA_EXTS):
            out.append((os.path.join(indir, fn), 0))
    return out


def build_corpus(files: Sequence[Tuple[str, int]]) -> Corpus:
    """Assemble the corpus from (path, genome_id) pairs.

    NOTE on file order: the reference iterates a std::map keyed by full
    path, i.e. lexicographic path order (src/build.cpp:86-91).  Callers
    wanting byte parity should pass files sorted by path; this function
    preserves the order given.
    """
    pieces: List[np.ndarray] = []
    contig_pos: List[int] = []
    ref_pos: List[int] = []
    ref_id: List[int] = []
    names: List[str] = []
    pos = 0
    contig_counter = 0

    for path, gid in files:
        contigs = _parse_fasta_contigs(path)
        for contig in contigs:
            if len(contig) == 0:
                continue
            fwd = ((contig.astype(np.uint16) + BASE_OFFSET) & 0xFF).astype(np.uint8)
            pieces.append(fwd)
            pos += len(fwd)
            pieces.append(_contig_separator(contig_counter))
            pos += 4
            contig_pos.append(pos)
            contig_counter += 1
            if contig_counter >= MAX_C:
                raise ValueError("Number of contigs exceeds limit.")
            rc_ascii = RC_IDX[contig[::-1]]
            rc = ((rc_ascii.astype(np.uint16) + BASE_OFFSET) & 0xFF).astype(np.uint8)
            pieces.append(rc)
            pos += len(rc)
            pieces.append(_contig_separator(contig_counter))
            pos += 4
            contig_pos.append(pos)
            contig_counter += 1
        ref_pos.append(pos)
        ref_id.append(gid)
        names.append(path)
        if len(ref_pos) >= MAX_M:
            raise ValueError("Number of reference genomes exceeds limit.")
    if pos >= MAX_N:
        raise ValueError("Total number of symbols exceeds limit.")

    seq = np.concatenate(pieces) if pieces else np.zeros(0, dtype=np.uint8)
    return Corpus(
        seq=seq,
        contig_pos=np.asarray(contig_pos, dtype=np.uint64),
        ref_pos=np.asarray(ref_pos, dtype=np.uint64),
        ref_id=np.asarray(ref_id, dtype=np.uint32),
        filenames=names,
    )


def build_corpus_streaming(files: Sequence[Tuple[str, int]],
                           seq_path: str) -> Corpus:
    """build_corpus with O(largest contig) coordinator memory: contig bytes
    stream straight to `seq_path` (raw uint8; np.memmap-able) instead of
    accumulating in RAM, and the returned Corpus's seq is a read-only
    memmap of that file.  The memory-honest companion of the cross-host
    build (parallel/dist_build.py) — at reference-cap corpora
    (maxN = 2^36, src/util.hpp:13) no single process can hold the text.
    Byte-identical to build_corpus (tested)."""
    contig_pos: List[int] = []
    ref_pos: List[int] = []
    ref_id: List[int] = []
    names: List[str] = []
    pos = 0
    contig_counter = 0
    with open(seq_path, "wb") as out:
        for path, gid in files:
            for contig in _parse_fasta_contigs(path):
                if len(contig) == 0:
                    continue
                fwd = ((contig.astype(np.uint16) + BASE_OFFSET)
                       & 0xFF).astype(np.uint8)
                out.write(fwd.tobytes())
                pos += len(fwd)
                out.write(_contig_separator(contig_counter).tobytes())
                pos += 4
                contig_pos.append(pos)
                contig_counter += 1
                if contig_counter >= MAX_C:
                    raise ValueError("Number of contigs exceeds limit.")
                rc_ascii = RC_IDX[contig[::-1]]
                rc = ((rc_ascii.astype(np.uint16) + BASE_OFFSET)
                      & 0xFF).astype(np.uint8)
                out.write(rc.tobytes())
                pos += len(rc)
                out.write(_contig_separator(contig_counter).tobytes())
                pos += 4
                contig_pos.append(pos)
                contig_counter += 1
            ref_pos.append(pos)
            ref_id.append(gid)
            names.append(path)
            if len(ref_pos) >= MAX_M:
                raise ValueError("Number of reference genomes exceeds limit.")
    if pos >= MAX_N:
        raise ValueError("Total number of symbols exceeds limit.")
    seq = (np.memmap(seq_path, dtype=np.uint8, mode="r") if pos
           else np.zeros(0, dtype=np.uint8))
    return Corpus(
        seq=seq,
        contig_pos=np.asarray(contig_pos, dtype=np.uint64),
        ref_pos=np.asarray(ref_pos, dtype=np.uint64),
        ref_id=np.asarray(ref_id, dtype=np.uint32),
        filenames=names,
    )


def corpus_from_sequences(genomes: Sequence[Sequence[bytes]],
                          genome_ids: Sequence[int] | None = None) -> Corpus:
    """Test/tooling helper: build a corpus from in-memory contig lists.

    genomes[g] is a list of ASCII contig byte strings for genome g.
    genome_ids defaults to 1..G (the conventional 1-based species ids).
    """
    if genome_ids is None:
        genome_ids = list(range(1, len(genomes) + 1))
    pieces: List[np.ndarray] = []
    contig_pos: List[int] = []
    ref_pos: List[int] = []
    pos = 0
    contig_counter = 0
    for contigs in genomes:
        for contig in contigs:
            arr = np.frombuffer(bytes(contig), dtype=np.uint8)
            fwd = ((arr.astype(np.uint16) + BASE_OFFSET) & 0xFF).astype(np.uint8)
            pieces.append(fwd)
            pos += len(fwd)
            pieces.append(_contig_separator(contig_counter))
            pos += 4
            contig_pos.append(pos)
            contig_counter += 1
            rc = RC_IDX[arr[::-1]]
            rc = ((rc.astype(np.uint16) + BASE_OFFSET) & 0xFF).astype(np.uint8)
            pieces.append(rc)
            pos += len(rc)
            pieces.append(_contig_separator(contig_counter))
            pos += 4
            contig_pos.append(pos)
            contig_counter += 1
        ref_pos.append(pos)
    seq = np.concatenate(pieces) if pieces else np.zeros(0, dtype=np.uint8)
    return Corpus(
        seq=seq,
        contig_pos=np.asarray(contig_pos, dtype=np.uint64),
        ref_pos=np.asarray(ref_pos, dtype=np.uint64),
        ref_id=np.asarray(list(genome_ids), dtype=np.uint32),
        filenames=[f"genome_{i}" for i in range(len(genomes))],
    )
