"""Device meshes over the ranks of the process group (port of
``parallel/mesh.py``). One rank drives one card (or, with the ``gloo``
backend, one CPU process), so a mesh's devices are ranks."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def device_count() -> int:
    """The devices of the job: the world's ranks under a process group, else
    the cards this process sees (at least 1)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return max(1, torch.cuda.device_count())


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a process group: launch with torchrun "
                           "(python -m torch.distributed.run) or call initialize_multihost")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> DeviceMesh:
    """1-D data-parallel mesh over the first ``n_devices`` ranks (default all).
    Every rank of the world calls it."""
    device_type = _device_type()
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} devices, the world has {world}")
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis_name,))


def grid_mesh(shape: Sequence[int],
              axis_names: Sequence[str] = ("data", "tile")) -> DeviceMesh:
    """N-D mesh over the first ``prod(shape)`` ranks, row-major, e.g.
    ``("data", "tile")``. Every rank of the world calls it."""
    device_type = _device_type()
    shape = tuple(int(s) for s in shape)
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(shape)} axes but {len(axis_names)} names")
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} devices, the world has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))
