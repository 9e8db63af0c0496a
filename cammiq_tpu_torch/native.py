"""ctypes binding to the repository's native C++ host engines (``native/``).

All four sources are bound, as ``cammiq_tpu/native.py`` binds them:

- ``sais.cpp``: SA-IS suffix array and Kasai LCP (``suffix_array``,
  ``lcp_kasai``);
- ``bsort.cpp``: the depth-bounded suffix sort and its clamped LCP
  (``bounded_sa``, ``bounded_lcp_u16``; ``has_bsort()``);
- ``sweeps.cpp``: the host build's narrow-dtype sweeps (``kasai_u16``,
  ``gsa32``, ``unique_lcp0_32``, ``doubly_lcp0_32``, ``occ_unique_u8``,
  ``occ_doubly_u8``, ``min_unique_u16``; ``has_sweeps()``) and the
  sparsified selection sweep ``select_sweep`` (``index/sparsify.py``);
- ``fastx.cpp``: the FASTQ parser ``parse_fastq`` (``io/fastq.py``).

The bindings are copies of ``cammiq_tpu/native.py`` (130-338, 367-383;
``_register_sweeps`` 90-128); the build is the port's own:

- the sources are compiled, unedited, with the flags of
  ``native/Makefile`` into one library in the git-ignored
  ``cammiq_tpu_torch/_build/`` (about 2.6 s cold for all four with g++
  on an 8-core host); ``native/`` itself is never written;
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
SOURCES = tuple(_PKG.parent / "native" / f for f in ("sais.cpp", "fastx.cpp", "sweeps.cpp",
                                                   "bsort.cpp"))
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
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.cammiq_sais64.restype = ctypes.c_int
    lib.cammiq_sais64.argtypes = [ctypes.POINTER(ctypes.c_uint8), i64p, i64]
    lib.cammiq_kasai.restype = None
    lib.cammiq_kasai.argtypes = [ctypes.POINTER(ctypes.c_uint8), i64p, i64p,
                                 i64, i64]
    lib.cammiq_parse_fastq.restype = i64
    lib.cammiq_parse_fastq.argtypes = [
        ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_int8), i32p, i64, i32,
        i32, ctypes.c_uint64,
    ]
    _register_sweeps(lib)
    _LIB = lib
    return _LIB


def _register_sweeps(lib) -> None:
    """Signatures for sweeps.cpp (production uniqueness pipeline) and
    bsort.cpp (the bounded sort), as ``cammiq_tpu/native.py`` registers
    them; here every source is always compiled in."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    cint = ctypes.c_int
    lib.cammiq_kasai_u16.restype = None
    lib.cammiq_kasai_u16.argtypes = [u8p, i64p, u16p, i64]
    lib.cammiq_gsa32.restype = None
    lib.cammiq_gsa32.argtypes = [i64p, i64p, i32p, i64, i32p, i64]
    lib.cammiq_unique_lcp0.restype = None
    lib.cammiq_unique_lcp0.argtypes = [i32p, u16p, i64, i32, i32p]
    lib.cammiq_doubly_lcp0.restype = None
    lib.cammiq_doubly_lcp0.argtypes = [i64p, i32p, u16p, i64, i32, i32, i32p, i32p]
    lib.cammiq_occ_unique.restype = None
    lib.cammiq_occ_unique.argtypes = [i64p, i32p, u16p, i32p, i64, cint, u8p]
    lib.cammiq_occ_doubly.restype = None
    lib.cammiq_occ_doubly.argtypes = [i64p, i32p, i32p, u16p, i32p, i64, i32, cint, u8p, u8p]
    lib.cammiq_min_unique.restype = None
    lib.cammiq_min_unique.argtypes = [i64p, i32p, i64, i32, u16p]
    lib.cammiq_select.restype = i64
    lib.cammiq_select.argtypes = [u8p, u16p, i64p, i64, i64p, i64, i64,
                                  i32, i32, i32, cint, i64p, i32p, i32p,
                                  i64p, i64]
    lib.cammiq_bounded_sa.restype = ctypes.c_int
    lib.cammiq_bounded_sa.argtypes = [u8p, i64, i64, i64p]
    lib.cammiq_bounded_lcp_u16.restype = None
    lib.cammiq_bounded_lcp_u16.argtypes = [u8p, i64, i64p, i64, u16p]


def available() -> bool:
    return _load() is not None


def has_sweeps() -> bool:
    """The narrow-dtype sweeps are built (always, with the library)."""
    return available()


def has_bsort() -> bool:
    """The bounded sort is built (always, with the library)."""
    return available()


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


def kasai_u16(s: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai LCP with uint16 clamped output ([n+1], lcp[0]=lcp[n]=0)."""
    lib = _load()
    s = np.ascontiguousarray(s, dtype=np.uint8)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    n = s.shape[0]
    lcp = np.zeros(n + 1, dtype=np.uint16)
    lib.cammiq_kasai_u16(_ptr(s, ctypes.c_uint8), _ptr(sa, ctypes.c_int64),
                         _ptr(lcp, ctypes.c_uint16), ctypes.c_int64(n))
    return lcp


def gsa32(sa: np.ndarray, ref_pos: np.ndarray, ref_id: np.ndarray) -> np.ndarray:
    """GSA[i] = ref_id[searchsorted(ref_pos, sa[i], 'right')] as int32."""
    lib = _load()
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    ref_pos = np.ascontiguousarray(ref_pos, dtype=np.int64)
    ref_id = np.ascontiguousarray(ref_id, dtype=np.int32)
    n = sa.shape[0]
    gsa = np.empty(n, dtype=np.int32)
    lib.cammiq_gsa32(_ptr(sa, ctypes.c_int64), _ptr(ref_pos, ctypes.c_int64),
                     _ptr(ref_id, ctypes.c_int32),
                     ctypes.c_int64(ref_pos.shape[0]),
                     _ptr(gsa, ctypes.c_int32), ctypes.c_int64(n))
    return gsa


def unique_lcp0_32(gsa: np.ndarray, lcp: np.ndarray, el: int) -> np.ndarray:
    lib = _load()
    gsa = np.ascontiguousarray(gsa, dtype=np.int32)
    lcp = np.ascontiguousarray(lcp, dtype=np.uint16)
    n = gsa.shape[0]
    out = np.empty(n, dtype=np.int32)
    lib.cammiq_unique_lcp0(_ptr(gsa, ctypes.c_int32), _ptr(lcp, ctypes.c_uint16),
                           ctypes.c_int64(n), ctypes.c_int32(el),
                           _ptr(out, ctypes.c_int32))
    return out


def doubly_lcp0_32(sa: np.ndarray, gsa: np.ndarray, lcp: np.ndarray,
                   el: int, ulmax: int):
    """Returns (lcp0 int32 [n] per rank, gsa2 int32 [n] per text pos)."""
    lib = _load()
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    gsa = np.ascontiguousarray(gsa, dtype=np.int32)
    lcp = np.ascontiguousarray(lcp, dtype=np.uint16)
    n = gsa.shape[0]
    lcp0 = np.empty(n, dtype=np.int32)
    gsa2 = np.zeros(n, dtype=np.int32)
    lib.cammiq_doubly_lcp0(_ptr(sa, ctypes.c_int64), _ptr(gsa, ctypes.c_int32),
                           _ptr(lcp, ctypes.c_uint16), ctypes.c_int64(n),
                           ctypes.c_int32(el), ctypes.c_int32(ulmax),
                           _ptr(lcp0, ctypes.c_int32), _ptr(gsa2, ctypes.c_int32))
    return lcp0, gsa2


def occ_unique_u8(sa: np.ndarray, gsa: np.ndarray, lcp: np.ndarray,
                  lcp0: np.ndarray, wrap: bool = False) -> np.ndarray:
    lib = _load()
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    gsa = np.ascontiguousarray(gsa, dtype=np.int32)
    lcp = np.ascontiguousarray(lcp, dtype=np.uint16)
    lcp0 = np.ascontiguousarray(lcp0, dtype=np.int32)
    n = gsa.shape[0]
    occ = np.zeros(n, dtype=np.uint8)
    lib.cammiq_occ_unique(_ptr(sa, ctypes.c_int64), _ptr(gsa, ctypes.c_int32),
                          _ptr(lcp, ctypes.c_uint16), _ptr(lcp0, ctypes.c_int32),
                          ctypes.c_int64(n), ctypes.c_int(1 if wrap else 0),
                          _ptr(occ, ctypes.c_uint8))
    return occ


def occ_doubly_u8(sa: np.ndarray, gsa: np.ndarray, gsa2_text: np.ndarray,
                  lcp: np.ndarray, lcp0: np.ndarray, ulmax: int,
                  wrap: bool = False):
    lib = _load()
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    gsa = np.ascontiguousarray(gsa, dtype=np.int32)
    gsa2_text = np.ascontiguousarray(gsa2_text, dtype=np.int32)
    lcp = np.ascontiguousarray(lcp, dtype=np.uint16)
    lcp0 = np.ascontiguousarray(lcp0, dtype=np.int32)
    n = gsa.shape[0]
    occ = np.zeros(n, dtype=np.uint8)
    occ2 = np.zeros(n, dtype=np.uint8)
    lib.cammiq_occ_doubly(_ptr(sa, ctypes.c_int64), _ptr(gsa, ctypes.c_int32),
                          _ptr(gsa2_text, ctypes.c_int32),
                          _ptr(lcp, ctypes.c_uint16), _ptr(lcp0, ctypes.c_int32),
                          ctypes.c_int64(n), ctypes.c_int32(ulmax),
                          ctypes.c_int(1 if wrap else 0),
                          _ptr(occ, ctypes.c_uint8), _ptr(occ2, ctypes.c_uint8))
    return occ, occ2


def min_unique_u16(sa: np.ndarray, lcp0: np.ndarray, n: int,
                   ulmax: int | None = None) -> np.ndarray:
    lib = _load()
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    lcp0 = np.ascontiguousarray(lcp0, dtype=np.int32)
    mu = np.full(n + 1, 0xFFFF, dtype=np.uint16)
    lib.cammiq_min_unique(_ptr(sa, ctypes.c_int64), _ptr(lcp0, ctypes.c_int32),
                          ctypes.c_int64(sa.shape[0]),
                          ctypes.c_int32(-1 if ulmax is None else ulmax),
                          _ptr(mu, ctypes.c_uint16))
    return mu


def suffix_array(s: np.ndarray) -> np.ndarray:
    """SA-IS suffix array of a uint8 text."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    s = np.ascontiguousarray(s, dtype=np.uint8)
    n = s.shape[0]
    sa = np.empty(n, dtype=np.int64)
    rc = lib.cammiq_sais64(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
    )
    if rc != 0:
        raise RuntimeError(f"native sais failed with code {rc}")
    return sa


def bounded_sa(s: np.ndarray, depth: int) -> np.ndarray:
    """Depth-bounded suffix sort (native/bsort.cpp): suffix order on the
    first `depth` bytes only; ties beyond `depth` in arbitrary order.
    Exact for every index consumer that thresholds LCPs at < depth-1
    (all of src/gsa.cpp:239-712 with depth >= L+2)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library not available: {_ERROR}")
    s = np.ascontiguousarray(s, dtype=np.uint8)
    n = s.shape[0]
    sa = np.empty(n, dtype=np.int64)
    rc = lib.cammiq_bounded_sa(
        _ptr(s, ctypes.c_uint8), ctypes.c_int64(n), ctypes.c_int64(depth),
        _ptr(sa, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"native bounded_sa failed with code {rc}")
    return sa


def bounded_lcp_u16(s: np.ndarray, sa: np.ndarray, cap: int) -> np.ndarray:
    """Adjacent-pair LCP clamped at `cap` ([n+1] uint16, lcp[0]=lcp[n]=0).
    Pair with bounded_sa(depth=cap): within a tie group the adjacent LCP
    is exactly cap, so the clamp is self-consistent."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library not available: {_ERROR}")
    s = np.ascontiguousarray(s, dtype=np.uint8)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    n = s.shape[0]
    lcp = np.zeros(n + 1, dtype=np.uint16)
    lib.cammiq_bounded_lcp_u16(
        _ptr(s, ctypes.c_uint8), ctypes.c_int64(n), _ptr(sa, ctypes.c_int64),
        ctypes.c_int64(cap), _ptr(lcp, ctypes.c_uint16))
    return lcp


def lcp_kasai(s: np.ndarray, sa: np.ndarray, clamp: int = 0xFFFF) -> np.ndarray:
    """Kasai LCP (convention: LCP[i] = lcp(SA[i-1], SA[i]), [n+1] output)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    s = np.ascontiguousarray(s, dtype=np.uint8)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    n = s.shape[0]
    lcp = np.zeros(n + 1, dtype=np.int64)
    lib.cammiq_kasai(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lcp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        ctypes.c_int64(clamp),
    )
    return lcp
