"""Attention U-Net for PDE solution super-resolution (port of
``models/unet.py``), NCHW.

* ``ConvBlock``: Conv3x3 -> norm -> ReLU, twice;
* encoder ``enc_features`` (default 64/128/256) with 2x max-pooling;
* dilated bridge: two Conv3x3 (dilation 2, padding 2) to ``bridge_features``;
* decoder with attention-gated skips, concatenated as ``[gating, skip]``, and
  align-corners bilinear 2x upsampling (the interpolation-matrix matmul of
  :mod:`~superresolution_for_pdes_tpu_torch.ops.resize`);
* attention gates: squeeze-excite channel attention (reduction 8) times
  spatial attention from the gating signal;
* head ``head_features`` (default 32/16) then a 1x1 conv to one channel, plus
  the residual input channel 0.

Module attributes follow the reference checkpoint namespace (``enc1.conv1``,
``enc1.bn1``, ``bridge.{0,1,3,4}``, ``att3.channel_attention.{1,3}``,
``att3.spatial_attention.0``, ``out_conv{i}``, ``out_bn{i}``, ``final``), so the
JAX package's ``torch_state_dict_to_variables`` reads a port state_dict as it
is. ``norm="group"`` uses GroupNorm with group size 8 when the channel count
is a multiple of 8, else 1 (the Flax rule); ``norm="batch"`` is
:class:`BatchNorm2d`, whose running variance in training follows Flax's.
Weights are Kaiming fan_out normal (ReLU gain), biases zero, norm scale 1 and
shift 0.

Parameter count at the default widths with 3 input channels: 7,834,588.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from superresolution_for_pdes_tpu_torch.ops.resize import resize_align_corners, upsample2x


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows Flax's ``BatchNorm``.

    Both normalize a training batch with its biased variance, but
    ``nn.BatchNorm2d`` averages the *unbiased* batch variance into
    ``running_var`` while Flax averages the biased one. In training mode this
    layer normalizes with the batch statistics and updates the running
    statistics itself: ``r <- r + momentum (batch - r)``, the biased variance
    included. Evaluation mode is ``nn.BatchNorm2d``'s.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return y


def make_norm(kind: str, features: int) -> nn.Module:
    if kind == "batch":
        return BatchNorm2d(features, eps=1e-5, momentum=0.1)
    if kind == "group":
        group_size = 8 if features % 8 == 0 else 1
        return nn.GroupNorm(features // group_size, features, eps=1e-5)
    raise ValueError(f"unknown norm kind: {kind!r}")


@torch.no_grad()
def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Kaiming fan_out normal convs (std ``sqrt(2 / fan_out)``), zero biases,
    norm scale 1 / shift 0, running stats (0, 1), for every submodule."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.reset_parameters()


class ConvBlock(nn.Module):
    """Conv3x3 -> norm -> ReLU, twice."""

    def __init__(self, cin: int, cout: int, norm: str = "batch"):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn1 = make_norm(norm, cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.bn2 = make_norm(norm, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class AttentionGate(nn.Module):
    """Channel (squeeze-excite, r=8) x spatial attention."""

    def __init__(self, features: int, gating_features: int, reduction: int = 8):
        super().__init__()
        self.channel_attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(features, features // reduction, 1),
            nn.ReLU(),
            nn.Conv2d(features // reduction, features, 1),
            nn.Sigmoid(),
        )
        self.spatial_attention = nn.Sequential(nn.Conv2d(gating_features, 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor, gating: torch.Tensor) -> torch.Tensor:
        x = x * self.channel_attention(x)
        if gating.shape[-2:] != x.shape[-2:]:
            gating = resize_align_corners(gating, tuple(x.shape[-2:]))
        return x * self.spatial_attention(gating)


class AttentionUNet(nn.Module):
    """The reference attention U-Net, NCHW. Input ``(N, in_channels, H, W)``,
    output ``(N, 1, H, W)``."""

    def __init__(self, in_channels: int = 3, enc_features: Sequence[int] = (64, 128, 256),
                 bridge_features: int = 512, head_features: Sequence[int] = (32, 16),
                 norm: str = "batch", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        f1, f2, f3 = enc_features
        self.enc1 = ConvBlock(in_channels, f1, norm)
        self.enc2 = ConvBlock(f1, f2, norm)
        self.enc3 = ConvBlock(f2, f3, norm)
        self.bridge = nn.Sequential(
            nn.Conv2d(f3, bridge_features, 3, padding=2, dilation=2),
            make_norm(norm, bridge_features),
            nn.ReLU(),
            nn.Conv2d(bridge_features, bridge_features, 3, padding=2, dilation=2),
            make_norm(norm, bridge_features),
            nn.ReLU(),
        )
        self.att3 = AttentionGate(f3, bridge_features)
        self.dec3 = ConvBlock(bridge_features + f3, f3, norm)
        self.att2 = AttentionGate(f2, f3)
        self.dec2 = ConvBlock(f3 + f2, f2, norm)
        self.att1 = AttentionGate(f1, f2)
        self.dec1 = ConvBlock(f2 + f1, f1, norm)
        cin = f1
        for i, feat in enumerate(head_features, start=1):
            setattr(self, f"out_conv{i}", nn.Conv2d(cin, feat, 3, padding=1))
            setattr(self, f"out_bn{i}", make_norm(norm, feat))
            cin = feat
        self.n_head = len(head_features)
        self.final = nn.Conv2d(cin, 1, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """:func:`init_weights` on every layer."""
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        coarse = x[:, 0:1]
        e1 = self.enc1(x)
        e2 = self.enc2(F.max_pool2d(e1, 2))
        e3 = self.enc3(F.max_pool2d(e2, 2))
        b = self.bridge(e3)
        d3 = self.dec3(torch.cat([b, self.att3(e3, b)], dim=1))
        up3 = upsample2x(d3)
        d2 = self.dec2(torch.cat([up3, self.att2(e2, up3)], dim=1))
        up2 = upsample2x(d2)
        d1 = self.dec1(torch.cat([up2, self.att1(e1, up2)], dim=1))
        h = d1
        for i in range(1, self.n_head + 1):
            h = F.relu(getattr(self, f"out_bn{i}")(getattr(self, f"out_conv{i}")(h)))
        return self.final(h) + coarse


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
