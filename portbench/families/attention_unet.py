"""The attention U-Net family (Superresolution_for_PDEs' ``src/models.py``):
the program's ``models/unet.py::AttentionUNet``, registered as
``attention_unet``.

Three encoder blocks with 2x max-pooling, a dilated bridge, three decoder
blocks each behind a squeeze-excite and spatial attention gate, a head of
3x3 convolutions and a 1x1 convolution to one channel, plus the coarse
solution (input channel 0). Every block is conv, BatchNorm, ReLU twice.

The reference departs from the program in arithmetic only: the
align-corners bilinear 2x upsampling is ``F.interpolate`` (the program
multiplies by dense interpolation matrices). Nothing here imports the
program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench import flops
from portbench.reference.layers import Layout, Params, batch_norm, bn_entries, conv, conv_entries

REDUCTION = 8  # squeeze-excite reduction of the attention gates
TRAINABLE = ("conv", "bias", "bn_weight", "bn_bias")
# widths at which the CPU tests run it
TINY = {"enc_features": [8, 16, 32], "bridge_features": 64, "head_features": [8, 8]}


def program_config(arch: Dict) -> Dict:
    """The program's registry name and keyword arguments of ``arch``."""
    return {"name": "attention_unet", "in_channels": arch["in_channels"],
            "enc_features": tuple(arch["enc_features"]),
            "bridge_features": arch["bridge_features"],
            "head_features": tuple(arch["head_features"])}


# ----------------------------------------------------------------- layout
def _block(name: str, cin: int, cout: int) -> Layout:
    return (conv_entries(f"{name}.conv1", cin, cout, 3) + bn_entries(f"{name}.bn1", cout)
            + conv_entries(f"{name}.conv2", cout, cout, 3) + bn_entries(f"{name}.bn2", cout))


def _gate(name: str, c: int, cg: int) -> Layout:
    return (conv_entries(f"{name}.channel_attention.1", c, c // REDUCTION, 1)
            + conv_entries(f"{name}.channel_attention.3", c // REDUCTION, c, 1)
            + conv_entries(f"{name}.spatial_attention.0", cg, 1, 1))


def layout(arch: Dict) -> Layout:
    """``[(key, shape, kind)]`` of the model's tensors."""
    f1, f2, f3 = arch["enc_features"]
    b = arch["bridge_features"]
    out = (_block("enc1", arch["in_channels"], f1) + _block("enc2", f1, f2)
           + _block("enc3", f2, f3)
           + conv_entries("bridge.0", f3, b, 3) + bn_entries("bridge.1", b)
           + conv_entries("bridge.3", b, b, 3) + bn_entries("bridge.4", b)
           + _gate("att3", f3, b) + _block("dec3", b + f3, f3)
           + _gate("att2", f2, f3) + _block("dec2", f3 + f2, f2)
           + _gate("att1", f1, f2) + _block("dec1", f2 + f1, f1))
    cin = f1
    for i, feat in enumerate(arch["head_features"], start=1):
        out += conv_entries(f"out_conv{i}", cin, feat, 3) + bn_entries(f"out_bn{i}", feat)
        cin = feat
    return out + conv_entries("final", cin, 1, 1)


# ----------------------------------------------------------------- forward
def _block_fwd(p: Params, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    x = F.relu(batch_norm(p, f"{name}.bn1", conv(p, f"{name}.conv1", x), train))
    return F.relu(batch_norm(p, f"{name}.bn2", conv(p, f"{name}.conv2", x), train))


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]), mode="bilinear",
                         align_corners=True)


def _gate_fwd(p: Params, name: str, x: torch.Tensor, gating: torch.Tensor) -> torch.Tensor:
    s = F.adaptive_avg_pool2d(x, 1)
    s = F.relu(conv(p, f"{name}.channel_attention.1", s, padding=0))
    x = x * torch.sigmoid(conv(p, f"{name}.channel_attention.3", s, padding=0))
    if gating.shape[-2:] != x.shape[-2:]:
        gating = F.interpolate(gating, size=tuple(x.shape[-2:]), mode="bilinear",
                               align_corners=True)
    return x * torch.sigmoid(conv(p, f"{name}.spatial_attention.0", gating, padding=0))


def forward(arch: Dict, p: Params, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """``(N, C, H, W) -> (N, 1, H, W)`` in float32."""
    e1 = _block_fwd(p, "enc1", x, train)
    e2 = _block_fwd(p, "enc2", F.max_pool2d(e1, 2), train)
    e3 = _block_fwd(p, "enc3", F.max_pool2d(e2, 2), train)
    b = F.relu(batch_norm(p, "bridge.1", conv(p, "bridge.0", e3, 2, 2), train))
    b = F.relu(batch_norm(p, "bridge.4", conv(p, "bridge.3", b, 2, 2), train))
    d3 = _block_fwd(p, "dec3", torch.cat([b, _gate_fwd(p, "att3", e3, b)], 1), train)
    up3 = _up2(d3)
    d2 = _block_fwd(p, "dec2", torch.cat([up3, _gate_fwd(p, "att2", e2, up3)], 1), train)
    up2 = _up2(d2)
    h = _block_fwd(p, "dec1", torch.cat([up2, _gate_fwd(p, "att1", e1, up2)], 1), train)
    for i in range(1, len(arch["head_features"]) + 1):
        h = F.relu(batch_norm(p, f"out_bn{i}", conv(p, f"out_conv{i}", h), train))
    return conv(p, "final", h, padding=0) + x[:, 0:1]


# ----------------------------------------------------------------- FLOPs
def _parts(arch: Dict, size: int) -> tuple[int, int, int]:
    """``(forward convolutions, first convolution, resizes)`` of one sample."""
    c = flops.conv
    cin, (f1, f2, f3), b = arch["in_channels"], arch["enc_features"], arch["bridge_features"]
    s1, s2, s3 = size, size // 2, size // 4

    def gate(ch, cg, s):
        return c(ch, ch // REDUCTION, 1, 1) + c(ch // REDUCTION, ch, 1, 1) + c(cg, 1, 1, s)

    first = c(cin, f1, 3, s1)
    convs = (first + c(f1, f1, 3, s1) + c(f1, f2, 3, s2) + c(f2, f2, 3, s2)
             + c(f2, f3, 3, s3) + c(f3, f3, 3, s3) + c(f3, b, 3, s3) + c(b, b, 3, s3)
             + gate(f3, b, s3) + c(b + f3, f3, 3, s3) + c(f3, f3, 3, s3)
             + gate(f2, f3, s2) + c(f3 + f2, f2, 3, s2) + c(f2, f2, 3, s2)
             + gate(f1, f2, s1) + c(f2 + f1, f1, 3, s1) + c(f1, f1, 3, s1))
    ch = f1
    for h in arch["head_features"]:
        convs += c(ch, h, 3, s1)
        ch = h
    convs += c(ch, 1, 1, s1)
    return convs, first, flops.up(f3, s3) + flops.up(f2, s2)


def flops_forward(arch: Dict, size: int) -> int:
    """One sample's forward pass at ``size x size``."""
    convs, _, resizes = _parts(arch, size)
    return convs + resizes


def flops_train_step(arch: Dict, size: int) -> int:
    """One sample's forward and backward pass at ``size x size``."""
    convs, first, resizes = _parts(arch, size)
    return 3 * convs - first + 2 * resizes
