"""Typed configuration objects: a copy of ``cammiq_tpu/config.py``.

The build, query and solver parameters of the JAX package, unchanged, so
both packages read the same flags the same way (``MeshConfig``, which
no caller reads, is not copied: the port's grid is
``parallel/mesh.py:ProcessGrid``).  The original replaces the
reference's hand-rolled argv loop and positional ``fine_parameters``
vectors (reference: src/main.cpp:74-446, src/query.cpp:231-236,305-306)
with explicit dataclasses.  Defaults are byte-for-byte the reference
defaults (src/main.cpp:450-467).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Validation bounds (reference: src/util.hpp:6-7, src/main.cpp:235-238,335-350)
MAX_K = 100
MAX_L = 1000
MIN_H = 5
MAX_H = 31

# Capacity caps (reference: src/util.hpp:13-15)
MAX_N = (2**64 - 1) >> 28       # max total corpus bytes
MAX_M = (2**32 - 1) >> 12       # max number of genomes
MAX_C = (2**32 - 1) >> 4        # max number of contigs


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Index-construction parameters (reference: src/main.cpp --build mode).

    k:     minimum substring length (reference -k; default 26).
    L:     read length the index is built for (reference -L; default 100).
    Lmax:  maximum substring length kept in the index (reference -Lmax;
           default 50).
    h:     hash (prefix) length for the unique index; h2 for the
           doubly-unique index (reference -h; default 26; both must be <= k).
    mode:  'unique' | 'doubly_unique' | 'both' (reference --unique /
           --doubly_unique / --both).
    num_groups: number of genome-range groups used by the sparsified index
           selection.  The reference partitions genomes over min(t, 4)
           pthreads, and the greedy selection state resets per thread
           (src/build.cpp:660,344-348); num_groups reproduces that
           partition deterministically.  Default 1 (same output as t=1).
    """

    k: int = 26
    L: int = 100
    Lmax: int = 50
    h: int = 26
    h2: Optional[int] = None
    mode: str = "both"
    num_groups: int = 1
    # bit-parity mode: emulate the reference's uint8 occurrence counters
    # wrapping mod 256 (src/gsa.cpp:546) instead of saturating at 255;
    # host engines only
    occ_u8_wrap: bool = False
    # bit-parity mode: reproduce the reference's if-advance over contig
    # boundaries in the unique sparsifier (src/build.cpp:362)
    unique_if_advance: bool = False
    # Depth-bounded suffix sort (native/bsort.cpp): sort suffixes on their
    # first sa_depth bytes only.  Every LCP0/OCC/MU consumer thresholds at
    # <= L+2 (src/gsa.cpp:239-712), so any sa_depth >= L+28 yields the
    # same index; deep-repeat (> sa_depth) *skipped* candidates may shift
    # position relative to the full-sort pipeline, which can differ in
    # contig-boundary ulm bookkeeping corner cases.  True = auto depth
    # (max(128, L+28) rounded up to 8); False = full SA-IS sort.
    bounded_sa: bool = True

    @property
    def sa_depth(self) -> int:
        return ((max(128, self.L + 28, self.Lmax + 28, self.h + 28) + 7)
                // 8 * 8)

    def __post_init__(self):
        if not (5 <= self.k <= MAX_K):
            raise ValueError(f"k must be in [5, {MAX_K}], got {self.k}")
        if not (0 < self.L <= MAX_L):
            raise ValueError(f"L must be in (0, {MAX_L}], got {self.L}")
        if not (self.k < self.Lmax <= MAX_L):
            raise ValueError(f"Lmax must be in (k, {MAX_L}], got {self.Lmax}")
        for hh in (self.h, self.h2):
            if hh is None:
                continue
            if not (MIN_H <= hh <= MAX_H):
                raise ValueError(f"h must be in [{MIN_H}, {MAX_H}], got {hh}")
            if hh > self.k:
                raise ValueError(f"h must be <= k, got h={hh} k={self.k}")
        if self.mode not in ("unique", "doubly_unique", "both"):
            raise ValueError(f"bad mode {self.mode!r}")
        if self.num_groups < 1:
            raise ValueError("num_groups must be >= 1")

    @property
    def h_doubly(self) -> int:
        return self.h2 if self.h2 is not None else self.h


@dataclasses.dataclass(frozen=True)
class FineParams:
    """Quantification fine parameters.

    Defaults per the reference (src/query.cpp:232-236): the positional
    vector (read_cnt_thres, easy_to_identify_thres, ilp_epsilon, ilp_alpha,
    max_depth) -> named fields here.
    """

    read_cnt_thres: int = 100           # additional_params[0]
    easy_to_identify_thres: int = 10000  # additional_params[1] ("unique_thres")
    ilp_epsilon: float = 0.01           # additional_params[2]
    ilp_alpha: float = 0.0001           # additional_params[3] ("resolution")
    max_cov: float = 100.0              # additional_params[4] ("max_depth")


@dataclasses.dataclass(frozen=True)
class IdentFineParams:
    """Identification (Type I/II) thresholds (reference: src/query.cpp:305-306)."""

    unique_read_cnt_thres: int = 10     # t1
    doubly_unique_read_cnt_thres: int = 5  # t2


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """Query-side parameters (reference: src/main.cpp --query mode)."""

    h: int = 26                     # hash length of the unique index
    h2: Optional[int] = None        # hash length of the doubly index
    erate: float = 0.0              # -e expected sequencing error rate
    min_read_len: int = 0           # --read_length_filter
    id_mode: int = 0                # 0=quant, 1=--read_cnts, 2=--read_cnts --doubly_unique
    fine: FineParams = dataclasses.field(default_factory=FineParams)
    ident: IdentFineParams = dataclasses.field(default_factory=IdentFineParams)
    batch_size: int = 65536         # reads per device batch (TPU-side knob)
    max_read_len: int = 256         # packed batch width (reference max_rl: src/query.hpp:34)

    def __post_init__(self):
        if not (0.0 <= self.erate <= 0.2):
            raise ValueError(f"erate must be in [0, 0.2], got {self.erate}")
        if self.id_mode not in (0, 1, 2):
            raise ValueError(f"bad id_mode {self.id_mode}")

    @property
    def h_doubly(self) -> int:
        return self.h2 if self.h2 is not None else self.h
