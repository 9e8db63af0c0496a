"""Build and bind the hand-written CUDA kernels (``cammiq_tpu_torch/csrc``).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``
(all at once), and the objects linked into one shared library with a plain C interface, loaded with ``ctypes`` (the same
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

from ..utils.timing import span

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
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


def _run(procs: list) -> str:
    """Wait for every (command, Popen), then raise on the first failure."""
    done = [(cmd, p, *p.communicate()) for cmd, p in procs]
    for cmd, p, stdout, stderr in done:
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {p.returncode}: "
                               f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    return "".join(stdout + stderr for _, _, stdout, stderr in done)


def build() -> Path:
    """Compile the kernel library unless an up-to-date one exists; return
    its path.  One nvcc per source, all started together, then one link.
    The compiler's resource report goes to ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        log = _run(procs)
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        log += _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built where missing and opened at the first
    call (the span ``kernels.load``)."""
    global _lib
    with _lock:
        if _lib is None:
            with span("kernels.load"):
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
    """The raw handle of ``device``'s current stream (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object: a few microseconds less a launch)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    index = device.index
    return raw(torch.cuda.current_device() if index is None else index)


VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float
