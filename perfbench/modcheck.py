"""The check that no JAX and nothing of the JAX package was loaded.

A module's top-level name (the part before the first dot) is compared whole:
``cammiq_tpu_torch.x`` is the port and passes, ``cammiq_tpu.x`` fails.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cammiq_tpu", "bench",
                       "benchmarks"})


def forbidden_modules(names=None) -> list:
    """Sorted names among ``names`` (default: ``sys.modules``) whose
    top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in list(names) if n.split(".", 1)[0] in FORBIDDEN)
