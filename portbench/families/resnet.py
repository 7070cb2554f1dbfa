"""The residual CNN family (identity-skip blocks, arXiv 1512.03385, as the
round-1 ResNet run): the program's ``models/resnet.py::PDEResNet``,
registered as ``resnet``.

A 3x3 ``stem`` convolution and ReLU; ``num_blocks`` blocks of conv,
BatchNorm, ReLU, conv, BatchNorm, then ReLU of the sum with the block's
input; a 1x1 ``head`` to one channel, plus the coarse solution (input
channel 0). Every layer runs at the input's resolution. Nothing here
imports the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench import flops
from portbench.reference.layers import Layout, Params, batch_norm, bn_entries, conv, conv_entries

TRAINABLE = ("conv", "bias", "bn_weight", "bn_bias")
# widths at which the CPU tests run it
TINY = {"features": 8, "num_blocks": 2}


def program_config(arch: Dict) -> Dict:
    """The program's registry name and keyword arguments of ``arch``."""
    return {"name": "resnet", "in_channels": arch["in_channels"], "features": arch["features"],
            "num_blocks": arch["num_blocks"]}


def layout(arch: Dict) -> Layout:
    """``[(key, shape, kind)]`` of the model's tensors."""
    feat = arch["features"]
    out = conv_entries("stem", arch["in_channels"], feat, 3)
    for i in range(1, arch["num_blocks"] + 1):
        out += (conv_entries(f"block{i}.conv1", feat, feat, 3) + bn_entries(f"block{i}.bn1", feat)
                + conv_entries(f"block{i}.conv2", feat, feat, 3)
                + bn_entries(f"block{i}.bn2", feat))
    return out + conv_entries("head", feat, 1, 1)


def forward(arch: Dict, p: Params, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """``(N, C, H, W) -> (N, 1, H, W)`` in float32."""
    h = F.relu(conv(p, "stem", x))
    for i in range(1, arch["num_blocks"] + 1):
        r = F.relu(batch_norm(p, f"block{i}.bn1", conv(p, f"block{i}.conv1", h), train))
        h = F.relu(h + batch_norm(p, f"block{i}.bn2", conv(p, f"block{i}.conv2", r), train))
    return conv(p, "head", h, padding=0) + x[:, 0:1]


def _parts(arch: Dict, size: int) -> tuple[int, int]:
    """``(forward convolutions, first convolution)`` of one sample."""
    cin, feat, blocks = arch["in_channels"], arch["features"], arch["num_blocks"]
    first = flops.conv(cin, feat, 3, size)
    return (first + 2 * blocks * flops.conv(feat, feat, 3, size)
            + flops.conv(feat, 1, 1, size)), first


def flops_forward(arch: Dict, size: int) -> int:
    """One sample's forward pass at ``size x size``."""
    return _parts(arch, size)[0]


def flops_train_step(arch: Dict, size: int) -> int:
    """One sample's forward and backward pass at ``size x size``."""
    convs, first = _parts(arch, size)
    return 3 * convs - first
