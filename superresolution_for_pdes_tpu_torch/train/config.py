"""Training configuration (port of ``train/config.py``): the same fields,
defaults and ``config.json`` as the JAX package.

Defaults are the published run: batch 32, <=500 epochs, AdamW lr 2e-4 /
weight decay 1e-4, plateau LR (factor 0.5, patience 10, min 1e-6), early
stopping 20, val split 0.2, grad clip 1.0, stratified split. ``dtype`` is
``float32`` or ``bfloat16`` (``train_model`` raises on any other).
``mesh_shape`` is read by neither package.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 32
    num_epochs: int = 500
    learning_rate: float = 2e-4
    weight_decay: float = 1e-4
    min_lr: float = 1e-6
    plateau_patience: int = 10
    plateau_factor: float = 0.5
    early_stopping_patience: int = 20
    val_split: float = 0.2
    grad_clip: float = 1.0
    seed: int = 42
    stratify_by_subdomain: bool = True
    model: str = "attention_unet"
    normalization: str = "dataset"  # "dataset" or "per_sample"
    # append log(u_std)/log(f_std) input channels (in_channels=5)
    scale_channels: bool = False
    model_norm: str = "batch"  # "batch" or "group"
    physics_weight: float = 0.0  # weight of the PDE-residual loss
    coarse_noise_std: float = 0.0  # train-time noise on the coarse input channel
    dtype: str = "float32"
    mesh_shape: Optional[int] = None
    log_tensorboard: bool = False
    checkpoint_every_best: bool = True
    # persist the best state at most every `checkpoint_interval` epochs, and
    # once at the end
    checkpoint_interval: int = 25
    fused_epochs: int = 0
    # regenerate a streamed training set every `gen_every` epochs
    gen_every: int = 1

    def to_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=4))

    @classmethod
    def from_json(cls, path: str | Path) -> "TrainConfig":
        return cls(**json.loads(Path(path).read_text()))
