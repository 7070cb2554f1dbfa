"""Split and batching utilities for the training loop (port of
``data/pipeline.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def stratified_split(seed: int, is_subdomain: np.ndarray,
                     val_split: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, val_idx): a per-stratum shuffled split that keeps the
    standard/subdomain mix in both splits; ``int(n_stratum * val_split)``
    samples of each stratum, and at least one of a stratum of 2 or more, go to
    validation. numpy, as in the JAX package, so both give the same indices."""
    rng = np.random.default_rng(seed)
    flags = np.asarray(is_subdomain, bool)
    train_parts, val_parts = [], []
    for value in (False, True):
        idx = np.nonzero(flags == value)[0]
        if idx.size == 0:
            continue
        perm = rng.permutation(idx)
        n_val = int(idx.size * val_split)
        if n_val == 0 and idx.size >= 2:
            n_val = 1
        val_parts.append(perm[:n_val])
        train_parts.append(perm[n_val:])
    return np.concatenate(train_parts), np.concatenate(val_parts)


def epoch_batch_indices(generator: torch.Generator, n_samples: int,
                        batch_size: int) -> torch.Tensor:
    """``(steps, batch_size)`` shuffled indices for one epoch, on the
    generator's device; the trailing partial batch is dropped."""
    if n_samples < batch_size:
        raise ValueError(
            f"batch_size={batch_size} exceeds the train split ({n_samples} samples): "
            "every epoch would run zero steps. Shrink --batch_size or grow the dataset.")
    perm = torch.randperm(n_samples, generator=generator, device=generator.device)
    steps = n_samples // batch_size
    return perm[: steps * batch_size].reshape(steps, batch_size)
