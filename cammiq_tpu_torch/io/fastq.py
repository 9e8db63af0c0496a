"""FASTQ ingestion -> packed read batches: a copy of ``cammiq_tpu/io/fastq.py``.

Reference: FqReader::readFastq (src/query.cpp:371-445): every 4-line
record's sequence, N replaced by a random base, optional min-length filter,
lengths as uint8 (max 255), total length tracked for the mean read length.

Device-side representation: a ReadBatch of 2-bit codes [B, Lpad] int8 with
per-read lengths [B]; the reverse-complement strand is derived on device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np

from ..ops.packing import SYMBOL_IDX


@dataclasses.dataclass
class ReadBatch:
    codes: np.ndarray     # int8 [B, Lpad] 2-bit codes (0..3), 0-padded
    lengths: np.ndarray   # int32 [B]
    count: int            # number of real reads (rest is padding)

    @property
    def capacity(self) -> int:
        return int(self.codes.shape[0])


@dataclasses.dataclass
class ReadSet:
    """All reads of one query file (host-side)."""

    codes: np.ndarray     # int8 [R, Lpad]
    lengths: np.ndarray   # int32 [R]
    total_len: int        # sum of read lengths (for mean read length)
    name: str

    @property
    def num_reads(self) -> int:
        return int(self.codes.shape[0])

    def batches(self, batch_size: int) -> Iterator[ReadBatch]:
        R = self.num_reads
        for s in range(0, max(R, 1), batch_size):
            e = min(s + batch_size, R)
            cnt = e - s
            codes = self.codes[s:e]
            lens = self.lengths[s:e]
            if cnt < batch_size:
                pad = batch_size - cnt
                codes = np.concatenate(
                    [codes, np.zeros((pad, codes.shape[1]), dtype=codes.dtype)]
                )
                lens = np.concatenate([lens, np.zeros(pad, dtype=lens.dtype)])
            yield ReadBatch(codes=codes, lengths=lens, count=cnt)


def read_fastq(
    path: str,
    min_len: int = 0,
    max_len: int = 256,
    rng: np.random.Generator | None = None,
    name: str | None = None,
    engine: str = "auto",
) -> ReadSet:
    """Load a FASTQ file into a ReadSet.

    N (or any non-ACGT symbol) is replaced by a random base, like the
    reference's `std::replace(N, alphabet[rand() & 3])`
    (src/query.cpp:383).  Reads shorter than min_len are dropped
    (--read_length_filter); reads longer than max_len are truncated (the
    reference stores lengths as uint8 and wraps - truncation is the sane
    equivalent).

    engine: 'auto' (native C++ parser when built, ~40x the Python loop),
    'native', or 'python'.  An explicit rng routes 'auto' to the python
    engine: the native parser draws N-substitutions from its own fixed
    LCG, so honoring the caller's generator requires the python path
    (pass engine='native' to override).
    """
    if engine == "auto":
        from .. import native

        engine = ("native" if native.available() and rng is None
                  else "python")
    if engine == "native":
        from .. import native

        with open(path, "rb") as f:
            data = f.read()
        codes, lengths = native.parse_fastq(data, max_len, min_len)
        return ReadSet(
            codes=codes,
            lengths=lengths,
            total_len=int(lengths.sum()),
            name=name or path.rsplit("/", 1)[-1],
        )
    rng = rng or np.random.default_rng(0)
    seqs: List[np.ndarray] = []
    lengths: List[int] = []
    total = 0
    with open(path, "rb") as f:
        while True:
            header = f.readline()
            if not header:
                break
            bases = f.readline().rstrip(b"\r\n")
            f.readline()
            f.readline()
            if len(bases) < max(min_len, 1):
                continue
            arr = np.frombuffer(bases, dtype=np.uint8)[:max_len]
            codes = SYMBOL_IDX[arr].astype(np.int8)
            bad = codes < 0
            if bad.any():
                codes = np.where(bad, rng.integers(0, 4, size=codes.shape).astype(np.int8), codes)
            seqs.append(codes)
            lengths.append(len(codes))
            total += len(codes)
    R = len(seqs)
    Lpad = max_len
    out = np.zeros((R, Lpad), dtype=np.int8)
    for i, c in enumerate(seqs):
        out[i, : len(c)] = c
    return ReadSet(
        codes=out,
        lengths=np.asarray(lengths, dtype=np.int32),
        total_len=total,
        name=name or path.rsplit("/", 1)[-1],
    )


def reads_from_arrays(seq_list: Sequence[bytes], max_len: int = 256,
                      name: str = "mem") -> ReadSet:
    """Test helper: build a ReadSet from ASCII read strings."""
    R = len(seq_list)
    out = np.zeros((R, max_len), dtype=np.int8)
    lengths = np.zeros(R, dtype=np.int32)
    total = 0
    for i, b in enumerate(seq_list):
        arr = np.frombuffer(bytes(b), dtype=np.uint8)[:max_len]
        codes = SYMBOL_IDX[arr].astype(np.int8)
        if (codes < 0).any():
            raise ValueError("non-ACGT in reads_from_arrays")
        out[i, : len(codes)] = codes
        lengths[i] = len(codes)
        total += len(codes)
    return ReadSet(codes=out, lengths=lengths, total_len=total, name=name)


def list_fastq_dir(indir: str) -> List[str]:
    """Directory scan (reference getFqList, src/query.cpp:207-229)."""
    import os

    out = []
    for fn in sorted(os.listdir(indir)):
        ext = fn.rsplit(".", 1)[-1]
        if ext in ("fq", "fastq"):
            out.append(os.path.join(indir, fn))
    return out
