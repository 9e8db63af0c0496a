"""The ``data x model`` grid of ranks: the counterpart of
``cammiq_tpu/parallel/mesh.py:make_mesh``.

JAX lays its devices out as ``devs.reshape(data, model)``; here the ranks
of the default ``torch.distributed`` process group take the same places:
rank ``r`` sits at ``(r // model, r % model)``.

- 'data': the reads of each batch are split over the ranks of a column;
- 'model': the merged index is split into bucket-aligned shards over the
  ranks of a row, and each batch's match slots are gathered inside it.

The backend is NCCL for CUDA devices and gloo for the CPU, and the grid
refuses any other pairing: a CUDA run never carries on over gloo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The one backend the grid takes for ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class ProcessGrid:
    """``data x model`` ranks of the default process group.

    Every rank of the world creates every group, in the same order
    (``new_group`` is collective over the world).  Ranks at or beyond
    ``data * model`` belong to no group (``active`` is False) and take no
    batches."""

    def __init__(self, data: int, model: int, device):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGrid needs an initialized process group")
        world, rank = dist.get_world_size(), dist.get_rank()
        if data < 1 or model < 1 or data * model > world:
            raise ValueError(f"grid {data}x{model} needs {data * model} ranks, "
                             f"the world has {world}")
        want = backend_for(device)
        if dist.get_backend() != want:
            raise RuntimeError(f"a grid on {torch.device(device).type} runs on "
                               f"{want}, the process group is on "
                               f"{dist.get_backend()}")
        n = data * model
        self.data, self.model, self.rank = data, model, rank
        self.device = torch.device(device)
        self.active = rank < n
        self.data_index, self.model_index = (divmod(rank, model) if self.active
                                             else (-1, -1))
        rows = [dist.new_group(list(range(d * model, (d + 1) * model)))
                for d in range(data)]
        cols = [dist.new_group(list(range(m, n, model))) for m in range(model)]
        everyone = dist.new_group(list(range(n)))
        self.model_group = rows[self.data_index] if self.active else None
        self.data_group = cols[self.model_index] if self.active else None
        self.group = everyone if self.active else None

    def data_slice(self, batch_size: int) -> slice:
        """This rank's contiguous rows of a global batch (``P("data",
        None)``); ``batch_size`` is a multiple of ``data``."""
        b = batch_size // self.data
        return slice(self.data_index * b, (self.data_index + 1) * b)
