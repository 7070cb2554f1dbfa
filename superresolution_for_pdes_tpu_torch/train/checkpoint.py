"""Training checkpoints with full train-state restore (the port's own format;
the JAX package writes orbax checkpoints).

A checkpoint is a directory holding ``checkpoint.pt``: a ``torch.save`` of a
dict with the model ``state_dict`` (``"model"``), the optimizer's
(``"optimizer"``), the plateau and early-stopping state, the epoch, the
losses and the normalization statistics (``"norm_stats"``, a dict of
tensors). Everything in it is a tensor, a number, a string or a container of
those, so it loads with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict

import torch

FILENAME = "checkpoint.pt"


def save_checkpoint(path: str | Path, payload: Dict[str, Any]) -> None:
    """Write ``payload`` to ``path/checkpoint.pt``, replacing the directory."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(payload, tmp / FILENAME)
    shutil.rmtree(path, ignore_errors=True)
    tmp.rename(path)


def restore_checkpoint(path: str | Path, map_location="cpu") -> Dict[str, Any]:
    """The payload saved at ``path`` (a checkpoint directory)."""
    return torch.load(Path(path) / FILENAME, map_location=map_location, weights_only=True)


def load_model_state(run_dir: str | Path, which: str = "best_model") -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` of ``run_dir/which``, or of ``run_dir`` when it
    is a checkpoint directory itself."""
    p = Path(run_dir)
    ckpt = p if (p / FILENAME).exists() else p / which
    return restore_checkpoint(ckpt)["model"]
