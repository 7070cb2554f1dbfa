"""The models' floating-point operations, counted from a configuration's
widths and a cell's shapes: what ``torch.utils.flop_counter`` counts for the
same model (``portbench/tests`` holds the two together).

A convolution is ``2 c_in c_out k^2`` per output point; its backward, the
same again for the weight gradient and once more for the input gradient,
except at the first layer, whose input takes no gradient. Biases,
normalisation and activations are not counted. The align-corners bilinear
2x upsampling of ``c`` channels from ``s x s`` is counted as the two dense
separable products that express it, ``12 c s^3`` (the program's form; 1.1%
of a served scene's count), and its backward as the same again.
"""

from __future__ import annotations

from typing import Dict


def _conv(cin: int, cout: int, k: int, size: int) -> int:
    return 2 * cin * cout * k * k * size * size


def _up(c: int, s: int) -> int:
    return 12 * c * s ** 3


def _unet(arch: Dict, size: int) -> tuple[int, int, int]:
    """``(forward convolutions, first convolution, resizes)`` of one sample."""
    cin, (f1, f2, f3), b = arch["in_channels"], arch["enc_features"], arch["bridge_features"]
    s1, s2, s3 = size, size // 2, size // 4
    r = 8  # squeeze-excite reduction of the attention gates

    def gate(c, cg, s):
        return _conv(c, c // r, 1, 1) + _conv(c // r, c, 1, 1) + _conv(cg, 1, 1, s)

    first = _conv(cin, f1, 3, s1)
    convs = (first + _conv(f1, f1, 3, s1) + _conv(f1, f2, 3, s2) + _conv(f2, f2, 3, s2)
             + _conv(f2, f3, 3, s3) + _conv(f3, f3, 3, s3)
             + _conv(f3, b, 3, s3) + _conv(b, b, 3, s3)
             + gate(f3, b, s3) + _conv(b + f3, f3, 3, s3) + _conv(f3, f3, 3, s3)
             + gate(f2, f3, s2) + _conv(f3 + f2, f2, 3, s2) + _conv(f2, f2, 3, s2)
             + gate(f1, f2, s1) + _conv(f2 + f1, f1, 3, s1) + _conv(f1, f1, 3, s1))
    c = f1
    for h in arch["head_features"]:
        convs += _conv(c, h, 3, s1)
        c = h
    convs += _conv(c, 1, 1, s1)
    return convs, first, _up(f3, s3) + _up(f2, s2)


def _resnet(arch: Dict, size: int) -> tuple[int, int, int]:
    cin, feat, blocks = arch["in_channels"], arch["features"], arch["num_blocks"]
    first = _conv(cin, feat, 3, size)
    convs = first + 2 * blocks * _conv(feat, feat, 3, size) + _conv(feat, 1, 1, size)
    return convs, first, 0


def _parts(arch: Dict, size: int) -> tuple[int, int, int]:
    if arch["family"] == "attention_unet":
        return _unet(arch, size)
    if arch["family"] == "resnet":
        return _resnet(arch, size)
    raise ValueError(f"unknown model family {arch['family']!r}")


def forward(arch: Dict, size: int) -> int:
    """One sample's forward pass at ``size x size``."""
    convs, _, resizes = _parts(arch, size)
    return convs + resizes


def train_step(arch: Dict, size: int) -> int:
    """One sample's forward and backward pass at ``size x size``."""
    convs, first, resizes = _parts(arch, size)
    return 3 * convs - first + 2 * resizes


def cascade_tiles(start: int, target: int, tiles) -> list[tuple[int, int]]:
    """``[(tiles per scene, fine tile size)]`` of each level of a cascade with
    non-overlapping coarse tiles ``tiles`` (one per level; the last repeats)."""
    out, res, i = [], start, 0
    while res < target:
        t = tiles[min(i, len(tiles) - 1)]
        out.append(((res // t) ** 2, 2 * t))
        res, i = 2 * res, i + 1
    return out


def served_scene(arch: Dict, start: int, target: int, tiles) -> int:
    """The model's forward passes over one scene's tiles, every level."""
    return sum(n * forward(arch, size) for n, size in cascade_tiles(start, target, tiles))
