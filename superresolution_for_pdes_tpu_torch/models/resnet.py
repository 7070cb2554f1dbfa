"""Residual CNN, the second model family (port of ``models/resnet.py``), NCHW.

A 3x3 ``stem`` conv and ReLU; ``num_blocks`` blocks ``block{i}``, each
conv1 -> norm -> ReLU -> conv2 -> norm, then ``relu(x + h)``; a 1x1 ``head``
to one channel, plus the residual input channel 0. No pooling: every layer
runs at the input's resolution. Module attributes follow the Flax names
(``stem``, ``block{i}.conv{1,2}``, ``block{i}.bn{1,2}``, ``head``), so that
``models/convert.py`` carries Flax weights over by renaming. Norms and
initialization are the attention U-Net's (:func:`~.unet.make_norm`,
:func:`~.unet.init_weights`).

Parameter count at the default widths with 3 input channels: 594,753.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from superresolution_for_pdes_tpu_torch.models.unet import init_weights, make_norm


class ResBlock(nn.Module):
    """Conv3x3 -> norm -> ReLU -> Conv3x3 -> norm, identity skip, ReLU."""

    def __init__(self, features: int, norm: str = "batch"):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.bn1 = make_norm(norm, features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = make_norm(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        return F.relu(x + self.bn2(self.conv2(h)))


class PDEResNet(nn.Module):
    """Constant-resolution residual CNN with the coarse-solution skip. Input
    ``(N, in_channels, H, W)``, output ``(N, 1, H, W)``."""

    def __init__(self, in_channels: int = 3, features: int = 64, num_blocks: int = 8,
                 norm: str = "batch", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.num_blocks = num_blocks
        self.stem = nn.Conv2d(in_channels, features, 3, padding=1)
        for i in range(1, num_blocks + 1):
            setattr(self, f"block{i}", ResBlock(features, norm))
        self.head = nn.Conv2d(features, 1, 1)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.stem(x))
        for i in range(1, self.num_blocks + 1):
            h = getattr(self, f"block{i}")(h)
        return self.head(h) + x[:, 0:1]
