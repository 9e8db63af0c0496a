"""Build and bind the hand-written CUDA kernels (``cammiq_tpu_torch/csrc``).

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` (the same
pattern ``cammiq_tpu/native.py`` uses for ``native/``).  The build runs at
the first kernel launch, never at import, into ``cammiq_tpu_torch/_build/``
(git-ignored).  The library name carries a hash of the sources and flags,
so an edited source is rebuilt.  A missing ``nvcc`` or a failed build
raises: there is no fallback to the plain PyTorch versions on a CUDA
tensor.

Each exported C function launches on the stream it is given and returns
the ``cudaError_t`` of its launches; ``CudaKernel.__call__`` raises on a
nonzero code and counts successful launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib = None
_lock = threading.Lock()


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled from "
        f"{CSRC} at first use and need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcammiq_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless an up-to-date one exists; return
    its path.  The compiler's resource report goes to ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {res.returncode}:\n{res.stdout}\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.cammiq_error_string.argtypes = [ctypes.c_int]
            lib.cammiq_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


class CudaKernel:
    """One exported C launcher.  ``launches`` counts successful launches;
    a caller may reset it to 0 to count the launches of one run."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err:
            msg = load().cammiq_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1


def check_tensor(t, name: str, dtype, device, ndim: int | None = None) -> None:
    """Reject what a kernel cannot take: wrong device, dtype, rank, or a
    non-contiguous layout (kernels index raw pointers)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
