"""ctypes binding to the repository's native C++ host engines (``native/``).

The port calls two of them: the sparsified selection sweep
(``cammiq_select``, ``native/sweeps.cpp``) of ``index/sparsify.py`` and the
FASTQ parser (``cammiq_parse_fastq``, ``native/fastx.cpp``) of
``io/fastq.py``.  The bindings are copies of ``cammiq_tpu/native.py``
(``_load``, ``select_sweep``, ``parse_fastq``); the build is the port's
own:

- the two sources are compiled, unedited, with the flags of
  ``native/Makefile`` into the git-ignored ``cammiq_tpu_torch/_build/``;
  ``native/`` itself is never written;
- the library is built at the first call that needs it, never at import,
  to a temporary name and ``os.replace``d into place while a file lock is
  held, so processes that build at the same time (test workers) wait for
  one build and never load a half-written library;
- the name carries a hash of the sources and flags, so an edited source is
  rebuilt.

Where no compiler can build it, ``available()`` is False and the callers
take their numpy engines (the same output); ``build_error()`` says why.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(_PKG.parent / "native" / f for f in ("fastx.cpp", "sweeps.cpp"))
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
            "-Wall", "-shared")

_LIB = None
_TRIED = False
_ERROR = ""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for p in SOURCES:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcammiq_native_{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """The library's path, compiled first if needed; None (and the reason
    in ``build_error()``) when no compiler builds it.  The default compiler
    is tried first, then the system g++ (the first may lack OpenMP)."""
    global _ERROR
    if not all(p.exists() for p in SOURCES):
        _ERROR = f"sources missing: {[str(p) for p in SOURCES]}"
        return None
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        errors = []
        for cxx in dict.fromkeys([os.environ.get("CXX", "g++"), "/usr/bin/g++"]):
            try:
                r = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp),
                                    *map(str, SOURCES)],
                                   capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                errors.append(f"{cxx}: {e}")
                continue
            if r.returncode == 0:
                os.replace(tmp, out)
                return out
            errors.append(f"{cxx}: rc={r.returncode} {r.stderr[-500:]}")
        tmp.unlink(missing_ok=True)
        _ERROR = " | ".join(errors)
        return None


def _load():
    global _LIB, _TRIED, _ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        _ERROR = str(e)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.cammiq_parse_fastq.restype = i64
    lib.cammiq_parse_fastq.argtypes = [
        ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_int8), i32p, i64, i32,
        i32, ctypes.c_uint64,
    ]
    lib.cammiq_select.restype = i64
    lib.cammiq_select.argtypes = [u8p, u16p, i64p, i64, i64p, i64, i64, i32,
                                  i32, i32, ctypes.c_int, i64p, i32p, i32p,
                                  i64p, i64]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def build_error() -> str:
    """Why the library is unavailable ('' when it loaded)."""
    _load()
    return _ERROR


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def select_sweep(seq: np.ndarray, mu: np.ndarray, contig_pos: np.ndarray,
                 ref_pos: np.ndarray, L: int, Lmax: int,
                 num_groups: int = 1, unique_if_advance: bool = False):
    """Sparsified selection sweep.  Returns (start int64 [S], length int32
    [S], ri int32 [S] genome-file indexes, ulm int64 [M])."""
    lib = _load()
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    mu = np.ascontiguousarray(mu, dtype=np.uint16)
    contig_pos = np.ascontiguousarray(contig_pos, dtype=np.int64)
    ref_pos = np.ascontiguousarray(ref_pos, dtype=np.int64)
    n = int(ref_pos[-1]) if ref_pos.size else 0
    M = ref_pos.shape[0]
    cap = n // max(L - Lmax, 1) + num_groups + 64
    out_start = np.empty(cap, np.int64)
    out_len = np.empty(cap, np.int32)
    out_ri = np.empty(cap, np.int32)
    ulm = np.zeros(M, np.int64)
    cnt = lib.cammiq_select(
        _ptr(seq, ctypes.c_uint8), _ptr(mu, ctypes.c_uint16),
        _ptr(contig_pos, ctypes.c_int64), ctypes.c_int64(contig_pos.shape[0]),
        _ptr(ref_pos, ctypes.c_int64), ctypes.c_int64(M), ctypes.c_int64(n),
        ctypes.c_int32(L), ctypes.c_int32(Lmax), ctypes.c_int32(num_groups),
        ctypes.c_int(1 if unique_if_advance else 0),
        _ptr(out_start, ctypes.c_int64), _ptr(out_len, ctypes.c_int32),
        _ptr(out_ri, ctypes.c_int32), _ptr(ulm, ctypes.c_int64),
        ctypes.c_int64(cap),
    )
    if cnt < 0:
        raise RuntimeError("cammiq_select output capacity exceeded")
    return out_start[:cnt], out_len[:cnt], out_ri[:cnt], ulm


def parse_fastq(data: bytes, max_len: int, min_len: int = 0,
                seed: int = 1):
    """Parse FASTQ bytes into (codes [R, max_len] int8, lengths [R] int32);
    N/non-ACGT bases become LCG-random bases (the parser's own generator,
    seeded by ``seed``)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library not available: {_ERROR}")
    nl = data.count(b"\n")
    max_reads = max(nl // 4 + 1, 1)
    codes = np.zeros((max_reads, max_len), np.int8)
    lengths = np.zeros(max_reads, np.int32)
    r = lib.cammiq_parse_fastq(
        data,
        ctypes.c_int64(len(data)),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(max_reads),
        ctypes.c_int32(max_len),
        ctypes.c_int32(min_len),
        ctypes.c_uint64(seed),
    )
    return codes[:r], lengths[:r]
