"""Plateau LR decay and early stopping between epochs (port of
``train/schedule.py``), with the same ``state_dict``.

* :class:`ReduceLROnPlateau`: mode 'min', relative threshold 1e-4, cooldown
  0; the LR is multiplied by ``factor`` once the metric has failed to improve
  for more than ``patience`` epochs, floored at ``min_lr``;
* :class:`EarlyStopping`: strict ``<`` improvement, stop after ``patience``
  stale epochs.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.5
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 1e-6
    best: float = math.inf
    num_bad_epochs: int = 0

    def step(self, metric: float) -> float:
        """Record an epoch metric; return the (possibly reduced) LR."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, state: dict) -> "ReduceLROnPlateau":
        return cls(**state)


@dataclasses.dataclass
class EarlyStopping:
    patience: int = 20
    best: float = math.inf
    best_epoch: int = 0
    num_bad_epochs: int = 0
    improved: bool = False  # whether the last step set a new best

    def step(self, metric: float, epoch: int) -> bool:
        """Record an epoch metric; return True when training should stop."""
        if metric < self.best:
            self.best = metric
            self.best_epoch = epoch
            self.num_bad_epochs = 0
            self.improved = True
        else:
            self.num_bad_epochs += 1
            self.improved = False
        return self.num_bad_epochs >= self.patience

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, state: dict) -> "EarlyStopping":
        return cls(**state)
