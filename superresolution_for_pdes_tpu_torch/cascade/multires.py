"""Multi-resolution ground truth for the cascade (port of
``cascade/multires.py``).

f and theta are built on the finest grid, stride-downsampled
``[::step, ::step]`` to every coarser resolution, and each resolution is solved
exactly with the DST solver (``refine_iters=1`` by default, as in JAX).

Each entry point is split in two: a sampling step, where a
``torch.Generator`` draws ``k1, k2 ~ U(k_range)`` and ``theta ~ U(theta_range)``
on the finest grid, and a deterministic step
(:func:`multi_resolution_from_params`) that takes ``k1``, ``k2`` and
``theta_finest`` explicitly, so a scene drawn elsewhere (e.g. by the JAX
package) can be fed in. A seed does not give the JAX package's scene: the two
random generators differ.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from superresolution_for_pdes_tpu_torch.data.generate import make_generator, uniform
from superresolution_for_pdes_tpu_torch.device import resolve_device
from superresolution_for_pdes_tpu_torch.ops.grid import forcing_term
from superresolution_for_pdes_tpu_torch.solver.dst import solve_poisson_dst


def multi_resolution_from_params(
    k1, k2, theta_finest: torch.Tensor, n_coarse: int = 40,
    resolutions: Sequence[int] = (80, 160, 320, 640), refine_iters: int = 1,
) -> Dict:
    """The deterministic step: ``{k1, k2, f: {res}, theta: {res}, u: {res}}``
    at ``[n_coarse] + resolutions`` from explicit wave numbers and the finest
    theta field ``(..., n, n)``; ``k1``/``k2`` are scalars or ``(B,)`` for a
    batch."""
    n_finest = max(resolutions)
    if theta_finest.shape[-1] != n_finest:
        raise ValueError(f"theta_finest is {tuple(theta_finest.shape)}, finest res {n_finest}")
    f_finest = forcing_term(k1, k2, n_finest, theta_finest.dtype, theta_finest.device)
    data: Dict = {"k1": k1, "k2": k2, "f": {}, "theta": {}, "u": {}}
    for res in [n_coarse] + list(resolutions):
        step = n_finest // res
        data["f"][res] = f_finest[..., ::step, ::step]
        data["theta"][res] = theta_finest[..., ::step, ::step]
        data["u"][res] = solve_poisson_dst(data["f"][res], data["theta"][res], refine_iters)
    return data


def solve_multi_resolution(
    seed_or_generator=0, n_coarse: int = 40,
    resolutions: Sequence[int] = (80, 160, 320, 640),
    k_range: Tuple[float, float] = (10.0, 11.0),
    theta_range: Tuple[float, float] = (0.5, 2.0),
    dtype=torch.float32, refine_iters: int = 1, device=None,
) -> Dict:
    """One scene: sample ``k1, k2 ~ U(k_range)`` and ``theta ~ U(theta_range)``
    from an int seed or a ``torch.Generator``, then solve every resolution on
    ``device`` (default ``cuda``; raises without a card)."""
    device = resolve_device(device)
    gen = make_generator(seed_or_generator, "cpu")
    n_finest = max(resolutions)
    k = uniform(gen, (2,), *k_range, dtype)
    theta = uniform(gen, (n_finest, n_finest), *theta_range, dtype).to(device)
    return multi_resolution_from_params(
        float(k[0]), float(k[1]), theta, n_coarse, resolutions, refine_iters)


def solve_multi_resolution_batch(
    seed_or_generator, n_scenes: int, n_coarse: int = 40,
    resolutions: Sequence[int] = (80, 160, 320, 640),
    k_range: Tuple[float, float] = (8.0, 12.0),
    theta_range: Tuple[float, float] = (0.5, 2.0),
    dtype=torch.float32, refine_iters: int = 1, device=None,
) -> Dict:
    """``n_scenes`` scenes; every field gains a leading ``(n_scenes,)`` axis."""
    device = resolve_device(device)
    gen = make_generator(seed_or_generator, "cpu")
    n_finest = max(resolutions)
    k = uniform(gen, (2, n_scenes), *k_range, dtype).to(device)
    theta = uniform(gen, (n_scenes, n_finest, n_finest), *theta_range, dtype).to(device)
    return multi_resolution_from_params(k[0], k[1], theta, n_coarse, resolutions, refine_iters)
