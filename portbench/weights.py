"""Seeded weights made on the device, in a few large calls, for both sides of
the comparison: the program loads them, the reference takes the same tensors
(or makes them again from the seed).

A model family's layout (``portbench/families/<family>.py``) gives each
tensor a kind. The shared kinds follow the law ``chip_smoke.py`` phase 4
gives its experts: convolution weights Kaiming normal with fan_out (std
``sqrt(2 / (c_out k^2))``), biases 0, BatchNorm scale 1 and shift 0, running
means N(0, 0.1) and running variances U(0.5, 2), step counts 0. Convolution
weights are one normal draw cut into tensors, the running statistics one
draw each. A kind a family adds is drawn by the family's own law,
``DRAWS[kind](generator, shapes, device)`` giving one tensor per shape in
layout order, from a generator of its own (tag 8), so that the shared
kinds' draws are the same whatever a family adds.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def derived_seed(seed: int, *tags: int) -> int:
    """A 64-bit seed that is a pure function of ``seed`` and ``tags``."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1, np.uint64)[0])


def generator(seed: int, device, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derived_seed(seed, *tags))


SHARED = ("conv", "bias", "bn_weight", "bn_bias", "running_mean", "running_var", "count")


def make_state_dict(family, arch: Dict, seed: int, device,
                    tag: int = 0) -> Dict[str, torch.Tensor]:
    """A state_dict of ``arch`` (a configuration's ``architecture``, of the
    model family ``family``) drawn from ``seed`` and ``tag`` on ``device``."""
    gen = generator(seed, device, 1, tag)
    entries = family.layout(arch)
    convs = [(k, s) for k, s, kind in entries if kind == "conv"]
    flat = torch.randn(sum(math.prod(s) for _, s in convs), generator=gen, device=device)
    out, at = {}, 0
    for key, shape in convs:
        n = math.prod(shape)
        fan_out = shape[0] * shape[2] * shape[3]
        out[key] = (flat[at:at + n] * math.sqrt(2.0 / fan_out)).reshape(shape)
        at += n
    stats = [(k, s) for k, s, kind in entries if kind == "running_mean"]
    n_stats = sum(s[0] for _, s in stats)
    means = torch.randn(n_stats, generator=gen, device=device) * 0.1
    variances = torch.rand(n_stats, generator=gen, device=device) * 1.5 + 0.5
    at = 0
    for key, shape in stats:
        out[key] = means[at:at + shape[0]]
        out[key.replace("running_mean", "running_var")] = variances[at:at + shape[0]]
        at += shape[0]
    fill = {"bias": 0.0, "bn_weight": 1.0, "bn_bias": 0.0}
    for key, shape, kind in entries:
        if kind in fill:
            out[key] = torch.full(shape, fill[kind], device=device)
        elif kind == "count":
            out[key] = torch.zeros((), dtype=torch.long, device=device)
    added: Dict[str, list] = {}
    for key, shape, kind in entries:
        if kind not in SHARED:
            added.setdefault(kind, []).append((key, shape))
    if added:
        own, draws = generator(seed, device, 8, tag), getattr(family, "DRAWS", {})
        for kind, items in added.items():
            if kind not in draws:
                raise ValueError(f"{family.__file__} draws no tensors of kind {kind!r}")
            out.update(zip((key for key, _ in items),
                           draws[kind](own, [shape for _, shape in items], device)))
    return {key: out[key].contiguous() for key, _, _ in entries}


def make_gains(seed: int, n_levels: int, shape, lo: float, hi: float, device) -> list:
    """Per-level modal gains, ``U(lo, hi)`` of ``shape``, in one draw."""
    gen = generator(seed, device, 2)
    draw = torch.rand((n_levels, *shape), generator=gen, device=device) * (hi - lo) + lo
    return list(draw.unbind(0))
