"""Training on data generated inside each step (port of
``parallel/online.py``; the north-star configuration "fused datagen").

Every step solves fresh PDEs on the device: draw (k1, k2) -> batched exact
solves -> normalize with frozen statistics -> forward/backward -> AdamW.
The model never sees a sample twice. The statistics are frozen from one
calibration batch (:func:`calibration_stats`), so the input scaling is
stationary, as with a pre-generated set.

Under a data-parallel group every rank draws the same global batch from an
identically seeded generator and steps on its contiguous part of it, with
global BatchNorm statistics and the group-mean gradient: the global batch a
step trains on does not depend on the world size.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from superresolution_for_pdes_tpu_torch.data.generate import (
    Dataset,
    generate_standard_dataset,
    generate_subdomain_dataset,
    make_generator,
)
from superresolution_for_pdes_tpu_torch.data.normalization import (
    NormStats,
    make_model_inputs,
    make_targets,
)
from superresolution_for_pdes_tpu_torch.device import resolve_device
from superresolution_for_pdes_tpu_torch.parallel import data as dpar


def _join(std: Dataset, sub: Dataset, key: str) -> torch.Tensor:
    return torch.cat([std[key], sub[key]])


def stats_from_sets(std: Dataset, sub: Dataset) -> NormStats:
    """Split-level statistics of the standard and subdomain sets together."""
    return NormStats.from_fields(*(_join(std, sub, key)
                                   for key in ("u_fine", "f_fine", "theta_fine")))


def calibration_stats(seed_or_generator, n_samples: int = 512,
                      subdomain_fraction: float = 0.5, device=None) -> NormStats:
    """Frozen statistics of a calibration mix: ``n_samples`` samples, the
    ``subdomain_fraction`` of them subdomain ones, drawn on ``device``
    (default ``cuda``) from an int seed or a generator."""
    gen = make_generator(seed_or_generator, device)
    n_sub = int(n_samples * subdomain_fraction)
    std = generate_standard_dataset(gen, n_samples - n_sub)
    sub = generate_subdomain_dataset(gen, n_sub)
    return stats_from_sets(std, sub)


def make_online_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                           stats: NormStats, batch_size: int,
                           subdomain_fraction: float = 0.5,
                           standard_k_range: Tuple[float, float] = (0.5, 5.0),
                           subdomain_k_range: Tuple[float, float] = (0.5, 12.0),
                           mesh=None, grad_clip: float = 1.0, device=None) -> Callable:
    """``step(generator) -> loss``: one MSE step on a freshly generated
    batch of ``batch_size`` samples (standard then subdomain, 1:1 by default),
    drawn from ``generator`` (on ``device``; it advances), with AdamW after
    the global-norm clip at ``grad_clip`` (the JAX package's optimizer chain).
    ``step.on_sets(std, sub)`` is the deterministic part, on given sets;
    ``step.steps`` counts the steps. The model moves to ``device`` (default
    ``cuda``; raises without a card). Under ``mesh`` (a 1-D ``DeviceMesh``)
    the step is data-parallel (module docstring), and ``batch_size`` must
    divide by its size."""
    from superresolution_for_pdes_tpu_torch.train.loop import clip_by_global_norm_

    model.to(resolve_device(device))
    n_sub = int(batch_size * subdomain_fraction)
    n_std = batch_size - n_sub
    dp = dpar.data_group(mesh)
    if dp is not None and batch_size % dp.world:
        raise ValueError(f"batch_size {batch_size} does not divide over {dp.world} ranks")
    dpar.broadcast_module(model, dp)
    dpar.sync_batch_norm(model, dp)

    def on_sets(std: Dataset, sub: Dataset) -> torch.Tensor:
        x = make_model_inputs(_join(std, sub, "u_coarse"), _join(std, sub, "f_fine"),
                              _join(std, sub, "theta_fine"), stats)
        y = make_targets(_join(std, sub, "u_fine"), stats)
        x, y = dpar.shard_rows(x, dp), dpar.shard_rows(y, dp)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = torch.mean((model(x) - y) ** 2)
        loss.backward()
        dpar.all_reduce_gradients(model.parameters(), dp)
        clip_by_global_norm_(model.parameters(), grad_clip)
        optimizer.step()
        step.steps += 1
        loss = loss.detach()
        return loss if dp is None else dpar.all_reduce_sum(loss, dp) / dp.world

    def step(generator: torch.Generator) -> torch.Tensor:
        std = generate_standard_dataset(generator, n_std, standard_k_range)
        sub = generate_subdomain_dataset(generator, n_sub, subdomain_k_range)
        return on_sets(std, sub)

    step.on_sets = on_sets
    step.steps = 0
    return step
