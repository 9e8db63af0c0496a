"""Device selection: an explicit device everywhere, never a silent CPU run."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
