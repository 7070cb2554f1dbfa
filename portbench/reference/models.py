"""Plain-PyTorch forward passes of the two model families, written from
their published description (the attention U-Net of Superresolution_for_PDEs'
``src/models.py`` and the residual CNN of its round-1 ResNet run), NCHW,
float32, with functional calls on a flat dict of tensors.

The dict's keys follow the checkpoint namespace the program reads
(``enc1.conv1.weight``, ``bridge.0.weight``, ``att3.channel_attention.1.weight``,
``out_conv1.weight``, ``final.weight``, ...), so the benchmark hands one dict of
weights it made itself to both sides.

Departures from the program, all of arithmetic and none of semantics:
- the align-corners bilinear 2x upsampling is ``F.interpolate`` (the program
  multiplies by dense interpolation matrices);
- BatchNorm is ``F.batch_norm`` with the running statistics in evaluation mode
  and the batch statistics (biased variance) in training mode; the running
  averages are not updated, since no compared number reads them.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

BN_EPS = 1e-5
REDUCTION = 8  # squeeze-excite reduction of the attention gates


# ----------------------------------------------------------------- layouts
def _conv(name: str, cin: int, cout: int, k: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{name}.weight", (cout, cin, k, k), "conv"), (f"{name}.bias", (cout,), "bias")]


def _bn(name: str, c: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{name}.weight", (c,), "bn_weight"), (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "running_mean"),
            (f"{name}.running_var", (c,), "running_var"),
            (f"{name}.num_batches_tracked", (), "count")]


def _block(name: str, cin: int, cout: int) -> list:
    return (_conv(f"{name}.conv1", cin, cout, 3) + _bn(f"{name}.bn1", cout)
            + _conv(f"{name}.conv2", cout, cout, 3) + _bn(f"{name}.bn2", cout))


def _gate(name: str, c: int, cg: int) -> list:
    return (_conv(f"{name}.channel_attention.1", c, c // REDUCTION, 1)
            + _conv(f"{name}.channel_attention.3", c // REDUCTION, c, 1)
            + _conv(f"{name}.spatial_attention.0", cg, 1, 1))


def unet_layout(in_channels: int, enc_features: Sequence[int], bridge_features: int,
                head_features: Sequence[int]) -> list:
    """``[(key, shape, kind)]`` of the attention U-Net's tensors."""
    f1, f2, f3 = enc_features
    b = bridge_features
    out = (_block("enc1", in_channels, f1) + _block("enc2", f1, f2) + _block("enc3", f2, f3)
           + _conv("bridge.0", f3, b, 3) + _bn("bridge.1", b)
           + _conv("bridge.3", b, b, 3) + _bn("bridge.4", b)
           + _gate("att3", f3, b) + _block("dec3", b + f3, f3)
           + _gate("att2", f2, f3) + _block("dec2", f3 + f2, f2)
           + _gate("att1", f1, f2) + _block("dec1", f2 + f1, f1))
    cin = f1
    for i, feat in enumerate(head_features, start=1):
        out += _conv(f"out_conv{i}", cin, feat, 3) + _bn(f"out_bn{i}", feat)
        cin = feat
    return out + _conv("final", cin, 1, 1)


def resnet_layout(in_channels: int, features: int, num_blocks: int) -> list:
    """``[(key, shape, kind)]`` of the residual CNN's tensors."""
    out = _conv("stem", in_channels, features, 3)
    for i in range(1, num_blocks + 1):
        out += (_conv(f"block{i}.conv1", features, features, 3) + _bn(f"block{i}.bn1", features)
                + _conv(f"block{i}.conv2", features, features, 3)
                + _bn(f"block{i}.bn2", features))
    return out + _conv("head", features, 1, 1)


def layout(arch: Dict) -> list:
    """The layout of a configuration's ``architecture`` entry."""
    if arch["family"] == "attention_unet":
        return unet_layout(arch["in_channels"], arch["enc_features"], arch["bridge_features"],
                           arch["head_features"])
    if arch["family"] == "resnet":
        return resnet_layout(arch["in_channels"], arch["features"], arch["num_blocks"])
    raise ValueError(f"unknown model family {arch['family']!r}")


# ----------------------------------------------------------------- forward
def conv(p: Params, name: str, x: torch.Tensor, padding: int = 1,
         dilation: int = 1) -> torch.Tensor:
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], padding=padding,
                    dilation=dilation)


def batch_norm(p: Params, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    if train:
        return F.batch_norm(x, None, None, p[f"{name}.weight"], p[f"{name}.bias"], True, 0.0,
                            BN_EPS)
    return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, BN_EPS)


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


def unet_forward(p: Params, x: torch.Tensor, n_head: int = 2, train: bool = False) -> torch.Tensor:
    """The attention U-Net: ``(N, C, H, W) -> (N, 1, H, W)``."""
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
    for i in range(1, n_head + 1):
        h = F.relu(batch_norm(p, f"out_bn{i}", conv(p, f"out_conv{i}", h), train))
    return conv(p, "final", h, padding=0) + x[:, 0:1]


def resnet_forward(p: Params, x: torch.Tensor, num_blocks: int = 8,
                   train: bool = False) -> torch.Tensor:
    """The residual CNN: ``(N, C, H, W) -> (N, 1, H, W)``."""
    h = F.relu(conv(p, "stem", x))
    for i in range(1, num_blocks + 1):
        r = F.relu(batch_norm(p, f"block{i}.bn1", conv(p, f"block{i}.conv1", h), train))
        h = F.relu(h + batch_norm(p, f"block{i}.bn2", conv(p, f"block{i}.conv2", r), train))
    return conv(p, "head", h, padding=0) + x[:, 0:1]


def forward(arch: Dict, p: Params, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """The forward pass of a configuration's ``architecture`` entry."""
    if arch["family"] == "attention_unet":
        return unet_forward(p, x, len(arch["head_features"]), train)
    return resnet_forward(p, x, arch["num_blocks"], train)
