"""Joining the processes of a job (port of ``parallel/multihost.py``).

The JAX package calls ``jax.distributed.initialize``. The port runs one
process per card and joins them with ``torch.distributed.init_process_group``:
``nccl`` for cards, ``gloo`` when the caller asks for the CPU. The rendezvous
comes from the arguments (``tcp://<coordinator_address>``) or from the
environment that ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from superresolution_for_pdes_tpu_torch.device import resolve_device

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None) -> dict:
    """Join this process to the job's process group and report the topology.

    ``coordinator_address`` (``host:port``) with ``num_processes`` and
    ``process_id`` name the rendezvous; without them ``torchrun``'s
    environment does. With neither, and ``num_processes`` in (None, 1), the
    job is this one process and no group is made (the JAX package's
    fallback). A group that already exists is kept. ``device`` is ``cuda``
    (the default: ``nccl``, and this process's card is ``LOCAL_RANK``'s) or
    ``cpu`` (``gloo``). Returns ``{process_index, process_count,
    local_devices, global_devices, local_rank, backend}``.
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError("coordinator_address needs num_processes and process_id")
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=int(num_processes), rank=int(process_id))
        elif all(key in os.environ for key in _TORCHRUN_ENV):
            dist.init_process_group(backend, init_method="env://")
        elif num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator address or "
                             "torchrun's environment")
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1, "local_devices": 1,
                "global_devices": 1, "local_rank": 0, "backend": None}
    if dist.get_backend() == "nccl":
        torch.cuda.set_device(local_rank)
    world = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": world, "local_devices": 1,
            "global_devices": world, "local_rank": local_rank, "backend": dist.get_backend()}
