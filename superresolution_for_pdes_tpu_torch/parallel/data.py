"""Data parallelism over a process group, in PyTorch's idiom (the port of the
JAX package's GSPMD batch sharding in ``train/loop.py``).

One process per card. Every rank holds the whole model and the whole data,
draws the same split, sets and index matrices, and trains on its contiguous
``1/world`` part of every global batch (:func:`shard_rows`). The port's
``BatchNorm2d`` layers take their training statistics over the global batch
(:func:`sync_batch_norm`), and the gradients are averaged over the group
before the global-norm clip (:func:`all_reduce_gradients`), so a step computes
the global batch's loss and gradient, as JAX's sharded step does.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch
import torch.distributed as dist
from torch import nn


class DataGroup(NamedTuple):
    """A process group with this process's rank in it and its size."""

    group: object
    rank: int
    world: int


def data_group(mesh) -> DataGroup | None:
    """The 1-D ``DeviceMesh``'s group (``None`` for no mesh)."""
    if mesh is None:
        return None
    if mesh.ndim != 1:
        raise ValueError(f"data parallelism takes a 1-D mesh, got {mesh.ndim} dimensions")
    return DataGroup(mesh.get_group(), mesh.get_local_rank(), mesh.size())


def shard_rows(t: torch.Tensor, dp: DataGroup | None) -> torch.Tensor:
    """This rank's contiguous part of the leading axis (all of it for no group)."""
    if dp is None:
        return t
    n = t.shape[0]
    if n % dp.world:
        raise ValueError(f"a batch of {n} does not split over {dp.world} ranks")
    part = n // dp.world
    return t[dp.rank * part:(dp.rank + 1) * part]


def sync_batch_norm(model: nn.Module, dp: DataGroup | None) -> int:
    """Point every port ``BatchNorm2d`` of ``model`` at the group (``None``
    restores per-process statistics). Returns the number of layers."""
    from superresolution_for_pdes_tpu_torch.models.unet import BatchNorm2d

    layers = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in layers:
        m.process_group = None if dp is None else dp.group
    return len(layers)


def broadcast_module(model: nn.Module, dp: DataGroup | None) -> None:
    """Rank 0's parameters and buffers on every rank (in place)."""
    if dp is None or dp.world == 1:
        return
    src = dist.get_global_rank(dp.group, 0)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t, src, group=dp.group)


def all_reduce_gradients(parameters: Iterable[nn.Parameter], dp: DataGroup | None) -> None:
    """Every gradient replaced by its mean over the group, in one all-reduce
    of one flat buffer."""
    if dp is None:
        return
    grads = [p.grad for p in parameters if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=dp.group)
    flat /= dp.world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_reduce_sum(t: torch.Tensor, dp: DataGroup | None) -> torch.Tensor:
    """``t`` summed over the group (a new tensor; ``t`` itself for no group)."""
    if dp is None:
        return t
    out = t.clone()
    dist.all_reduce(out, group=dp.group)
    return out


def barrier(dp: DataGroup | None) -> None:
    if dp is not None:
        dist.barrier(group=dp.group)


def is_writer(dp: DataGroup | None) -> bool:
    """Whether this process writes the run's files (rank 0, or no group)."""
    return dp is None or dp.rank == 0
