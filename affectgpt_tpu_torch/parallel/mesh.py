"""The data-parallel layout of the PyTorch port.

Port of affectgpt_tpu/parallel/mesh.py's role in training (reference:
my_affectgpt/common/dist_utils.py:54-79, runner_base.py:103-109): the JAX
package lays a ("dp", "tp") mesh over its devices and lets the compiler
insert the collectives; here each process drives one card (or the CPU),
`torch.distributed` names its rank and the world, and the training step
sums its gradients over the ranks itself (`training.train_step`). Every
rank loads its own share of the global batch: `run.batch_size_train`
samples, a global batch of that times the world size, as JAX's
`batch_size_train · dp`.

Tensor parallelism (the mesh's "tp" axis, `run.tp > 1`) is not ported:
`create_layout` raises NotImplementedError for it (ROADMAP queue 1 item
11c, with the servers' `mesh`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataParallel:
    """One process's place in the data-parallel world."""

    world_size: int
    rank: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def create_layout(device="cuda", tp: int = 1) -> DataParallel:
    """The layout of this process: rank and world size from an initialized
    torch.distributed group (one rank, rank 0, without one), on `device`;
    a CUDA device without an index takes the card of the local rank."""
    if int(tp) > 1:
        raise NotImplementedError(
            "tensor parallelism (run.tp > 1) is not ported to PyTorch yet "
            "(ROADMAP queue 1 item 11c)")
    world, rank = (dist.get_world_size(), dist.get_rank()) if distributed() else (1, 0)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return DataParallel(world_size=world, rank=rank, device=device)


def all_reduce_sum(tensors: List[torch.Tensor], layout: Optional[DataParallel]) -> None:
    """Sum `tensors` over the ranks in place, as one flat buffer per dtype
    (one collective each); nothing to do on one rank (or no layout)."""
    if layout is None or layout.world_size <= 1 or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast(tensors: List[torch.Tensor], layout: DataParallel, src: int = 0) -> None:
    """Give every rank rank `src`'s values of `tensors`, in place."""
    if layout.world_size <= 1:
        return
    for t in tensors:
        dist.broadcast(t, src)


def barrier(layout: DataParallel) -> None:
    if layout.world_size > 1:
        dist.barrier()
