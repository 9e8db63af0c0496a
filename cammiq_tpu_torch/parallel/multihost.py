"""Process-group set-up for a launched run: the counterpart of
``cammiq_tpu/parallel/multihost.py``.

A launcher (``torchrun``, or any that sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) starts one process a
rank.  ``initialize_cluster`` joins them into the default process group
only when ``WORLD_SIZE > 1``, as the JAX package skips
``jax.distributed.initialize`` when no cluster is configured; each rank's
card is ``cuda:LOCAL_RANK``.

``global_batch_from_local`` has no counterpart: JAX assembles one global
array from every host's reads, while here each rank takes its own rows of
every batch (``ProcessGrid.data_slice``) and nothing global is built.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import backend_for

# how long a collective may wait for the slowest rank (a rank building its
# index shard from a large artifact takes minutes)
TIMEOUT = datetime.timedelta(minutes=15)


def local_device(device) -> torch.device:
    """``cuda:LOCAL_RANK`` for a CUDA run under a launcher, else
    ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def initialize_cluster(device, timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the launcher's ranks into the default process group (NCCL for
    a CUDA ``device``, gloo for the CPU) when ``WORLD_SIZE > 1``; returns
    whether a group of more than one rank is up.  A failed NCCL set-up
    raises: there is no fallback to gloo or to one card."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method="env://",
                            timeout=timeout)
    return True


def host_shard_of_files(files, rank: int | None = None,
                        world: int | None = None) -> list:
    """Round-robin assignment of query files to this rank (the default
    process group's rank and size unless given)."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    return [f for i, f in enumerate(files) if i % world == rank]
