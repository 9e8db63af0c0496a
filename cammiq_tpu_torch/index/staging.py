"""Disk staging for large builds: a copy of ``cammiq_tpu/index/staging.py``
(the same on-disk format, so either package resumes the other's stages).

The reference trades RAM for disk by spilling SA/GSA/LCP to temp files
between stages (gsa.bin / sa0.bin / lcp.bin, src/gsa.cpp:88-137,193-237,
810-820).  The TPU build's equivalent: a BuildStage directory of memmapped
arrays, making every pipeline stage resumable - kill the build after the
suffix array and it continues from the LCP stage.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


class StageStore:
    """Directory of named numpy arrays with a manifest; supports memmap
    loads so later stages stream from disk instead of resident RAM."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._manifest_path = os.path.join(path, "manifest.json")
        self.manifest: Dict[str, dict] = {}
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self.manifest = json.load(f)

    def has(self, name: str) -> bool:
        return name in self.manifest and os.path.exists(
            os.path.join(self.path, f"{name}.bin")
        )

    def save(self, name: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        with open(os.path.join(self.path, f"{name}.bin"), "wb") as f:
            f.write(arr.tobytes())
        self.manifest[name] = {"dtype": str(arr.dtype), "shape": list(arr.shape)}
        with open(self._manifest_path, "w") as f:
            json.dump(self.manifest, f)

    def load(self, name: str, mmap: bool = True) -> np.ndarray:
        meta = self.manifest[name]
        path = os.path.join(self.path, f"{name}.bin")
        if mmap:
            return np.memmap(path, dtype=np.dtype(meta["dtype"]),
                             mode="r", shape=tuple(meta["shape"]))
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), dtype=np.dtype(meta["dtype"])).reshape(
                meta["shape"]
            )

    def delete(self, name: str) -> None:
        p = os.path.join(self.path, f"{name}.bin")
        if os.path.exists(p):
            os.remove(p)
        self.manifest.pop(name, None)
        with open(self._manifest_path, "w") as f:
            json.dump(self.manifest, f)


def staged(store: Optional[StageStore], name: str, compute, mmap: bool = True):
    """Memoize an array-producing stage in the store (resume support)."""
    if store is None:
        return compute()
    if store.has(name):
        return store.load(name, mmap=mmap)
    arr = compute()
    store.save(name, np.asarray(arr))
    return arr
