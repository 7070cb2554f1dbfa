"""Dataset ``.npz`` import/export (port of ``data/io.py``).

The schema is the JAX package's and the reference's: keys ``u_coarse,
u_fine, f_coarse, f_fine, theta_coarse, theta_fine, k1, k2`` and
``is_subdomain``, at ``<dir>/pde_dataset.npz`` by default, so a dataset
written by either package loads in the other.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from superresolution_for_pdes_tpu_torch.device import resolve_device

DEFAULT_FILENAME = "pde_dataset.npz"


def save_dataset(dataset: Dict[str, torch.Tensor], path) -> Path:
    """Save a dataset dict as ``.npz``; ``path`` is a directory or a
    ``*.npz`` file."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path / DEFAULT_FILENAME
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in dataset.items()})
    return path


def load_dataset(path, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Load an ``.npz`` dataset onto ``device`` (default ``cuda``; raises
    without a card). Floating fields are cast to ``dtype``; other arrays keep
    their type. A missing ``is_subdomain`` (the reference's standard sets)
    reads as all False."""
    device = resolve_device(device)
    path = Path(path)
    if path.is_dir():
        path = path / DEFAULT_FILENAME
    out: Dict[str, torch.Tensor] = {}
    with np.load(path) as npz:
        for k in npz.files:
            v = npz[k]
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.to(device, dtype) if np.issubdtype(v.dtype, np.floating) else t.to(device)
    if "is_subdomain" not in out:
        out["is_subdomain"] = torch.zeros(out["u_fine"].shape[0], dtype=torch.bool,
                                          device=device)
    return out
