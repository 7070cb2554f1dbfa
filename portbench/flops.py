"""Floating-point operations counted from a configuration's widths and a
cell's shapes: what ``torch.utils.flop_counter`` counts for the same model
(``portbench/tests`` holds the two together).

Each model family's file (``portbench/families/<family>.py``) gives
``flops_forward(arch, size)`` and ``flops_train_step(arch, size)`` of one
sample from the pieces here; this module adds what does not depend on the
family: the tiles of a served cascade and a served scene's total.

A convolution is ``2 c_in c_out k^2`` per output point; its backward, the
same again for the weight gradient and once more for the input gradient,
except at the first layer, whose input takes no gradient. Biases,
normalisation and activations are not counted. The align-corners bilinear
2x upsampling of ``c`` channels from ``s x s`` is counted as the two dense
separable products that express it, ``12 c s^3`` (the program's form), and
its backward as the same again.
"""

from __future__ import annotations

from typing import Dict


def conv(cin: int, cout: int, k: int, size: int) -> int:
    """A ``k x k`` convolution's forward at ``size x size`` outputs."""
    return 2 * cin * cout * k * k * size * size


def up(c: int, s: int) -> int:
    """The align-corners bilinear 2x upsampling of ``c`` channels from ``s x s``."""
    return 12 * c * s ** 3


def cascade_tiles(start: int, target: int, tiles) -> list[tuple[int, int]]:
    """``[(tiles per scene, fine tile size)]`` of each level of a cascade with
    non-overlapping coarse tiles ``tiles`` (one per level; the last repeats)."""
    out, res, i = [], start, 0
    while res < target:
        t = tiles[min(i, len(tiles) - 1)]
        out.append(((res // t) ** 2, 2 * t))
        res, i = 2 * res, i + 1
    return out


def served_scene(family, arch: Dict, start: int, target: int, tiles) -> int:
    """The model's forward passes over one scene's tiles, every level."""
    return sum(n * family.flops_forward(arch, size)
               for n, size in cascade_tiles(start, target, tiles))
