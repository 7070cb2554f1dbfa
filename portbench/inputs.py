"""The benchmark's inputs, made on the device from the seed by its own code:
scenes to serve and sets to train on. Both sides of the comparison get the
same tensors; the program's own generators are not used.

A scene is ``f = sin(2 pi k1 x) sin(2 pi k2 y)`` and ``theta ~ U(0.5, 2)``
pointwise on the finest ``n x n`` vertex grid of ``[0, 1]^2`` (x along
columns), strided ``[::s, ::s]`` to every coarser level, with the exact
solution of ``theta * L u = f`` at the coarsest level (float64 DST-I, stored
in float32) as the cascade's start.

A training set follows a recipe of the configuration (the laws of the
repository's ``generate_data``): standard samples (f and theta on separate
20^2 and 40^2 grids, both solved), subdomain samples (an 80^2 solve and a
40^2 window of it at a random origin, strided to 20^2), each with theta
constant 1 and then pointwise U(0.5, 2) when the recipe's theta is
``mixed``; and cascade tiles (per scene and level pair ``r -> 2r``, matched
windows of 20 points at r and 40 at 2r, each level solved on its own).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from portbench.reference.cascade import solve_poisson

THETA_RANGE = (0.5, 2.0)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def forcing(k1: torch.Tensor, k2: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, n, n)`` ``sin(2 pi k1 x_j) sin(2 pi k2 y_i)``, formed in float64."""
    g = torch.arange(n, dtype=torch.float64, device=k1.device) / (n - 1)
    k1, k2 = k1.double()[:, None, None], k2.double()[:, None, None]
    return (torch.sin(2 * math.pi * k1 * g[None, None, :])
            * torch.sin(2 * math.pi * k2 * g[None, :, None])).float()


def solve(f: torch.Tensor, theta: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """Exact float64 solves of ``(B, n, n)`` problems, in chunks, as float32."""
    return torch.cat([solve_poisson(f[i:i + chunk].double(), theta[i:i + chunk].double()).float()
                      for i in range(0, f.shape[0], chunk)])


def scene_pool(gen: torch.Generator, n_scenes: int, start: int, finest: int,
               k_range: Sequence[float]) -> Dict:
    """``{"u0": (B, start, start), "f": {res: ...}, "theta": {res: ...}}`` for
    every level above ``start`` up to ``finest``."""
    k = _uniform(gen, (2, n_scenes), *k_range)
    theta = _uniform(gen, (n_scenes, finest, finest), *THETA_RANGE)
    f = forcing(k[0], k[1], finest)
    out = {"f": {}, "theta": {}}
    res = start
    while res <= finest:
        step = finest // res
        out["f"][res] = f[:, ::step, ::step].contiguous()
        out["theta"][res] = theta[:, ::step, ::step].contiguous()
        res *= 2
    out["u0"] = solve(out["f"][start], out["theta"][start])
    del out["f"][start], out["theta"][start]
    return out


def _windows(field: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, size: int) -> torch.Tensor:
    """``(size, size)`` windows of ``(B, n, n)`` at origins of shape ``(B, T)``,
    flattened to ``(B * T, size, size)``."""
    ar = torch.arange(size, device=field.device)
    rows = (oy[..., None] + ar)[..., :, None]
    cols = (ox[..., None] + ar)[..., None, :]
    batch = torch.arange(field.shape[0], device=field.device)[:, None, None, None]
    return field[batch, rows, cols].flatten(0, 1)


def _standard(gen, n: int, k_range, constant: bool) -> Dict:
    k = _uniform(gen, (2, n), *k_range)
    theta = torch.ones(n, 40, 40, device=gen.device) if constant else \
        _uniform(gen, (n, 40, 40), *THETA_RANGE)
    f_fine, f_coarse = forcing(k[0], k[1], 40), forcing(k[0], k[1], 20)
    return {"u_fine": solve(f_fine, theta), "u_coarse": solve(f_coarse, theta[:, ::2, ::2]),
            "f_fine": f_fine, "theta_fine": theta}


def _subdomain(gen, n: int, k_range, constant: bool) -> Dict:
    k = _uniform(gen, (2, n), *k_range)
    theta = torch.ones(n, 80, 80, device=gen.device) if constant else \
        _uniform(gen, (n, 80, 80), *THETA_RANGE)
    origin = torch.randint(0, 40, (2, n, 1), generator=gen, device=gen.device)
    f = forcing(k[0], k[1], 80)
    u = solve(f, theta)
    u_fine, f_fine, theta_fine = (_windows(x, origin[0], origin[1], 40) for x in (u, f, theta))
    return {"u_fine": u_fine, "u_coarse": u_fine[:, ::2, ::2].contiguous(), "f_fine": f_fine,
            "theta_fine": theta_fine}


def _cascade_tiles(gen, n_scenes: int, tiles: int, k_range, finest: int, coarsest: int,
                   tile: int, chunk: int = 64) -> Dict:
    parts = []
    for start in range(0, n_scenes, chunk):
        b = min(chunk, n_scenes - start)
        k = _uniform(gen, (2, b), *k_range)
        theta_f = _uniform(gen, (b, finest, finest), *THETA_RANGE)
        f_f = forcing(k[0], k[1], finest)
        levels, res = {}, coarsest
        while res <= finest:
            step = finest // res
            f_r = f_f[:, ::step, ::step].contiguous()
            t_r = theta_f[:, ::step, ::step].contiguous()
            levels[res] = (solve(f_r, t_r), f_r, t_r)
            res *= 2
        out = {key: [] for key in ("u_fine", "u_coarse", "f_fine", "theta_fine")}
        for r in sorted(levels)[:-1]:
            origin = torch.randint(0, r - tile + 1, (2, b, tiles), generator=gen,
                                   device=gen.device)
            (u_r, _, _), (u_2r, f_2r, t_2r) = levels[r], levels[2 * r]
            out["u_coarse"].append(_windows(u_r, origin[0], origin[1], tile))
            for key, field in (("u_fine", u_2r), ("f_fine", f_2r), ("theta_fine", t_2r)):
                out[key].append(_windows(field, 2 * origin[0], 2 * origin[1], 2 * tile))
        parts.append({key: torch.cat(v) for key, v in out.items()})
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def training_set(gen: torch.Generator, recipe: Dict) -> Dict[str, torch.Tensor]:
    """The raw set of a configuration's training recipe (``u_fine``,
    ``u_coarse``, ``f_fine``, ``theta_fine``), in the recipe's order."""
    strata = {"constant": (True,), "varying": (False,), "mixed": (True, False)}[recipe["theta"]]
    parts = []
    for constant in strata:
        if recipe["n_standard"]:
            parts.append(_standard(gen, recipe["n_standard"], recipe["standard_k"], constant))
        if recipe["n_subdomain"]:
            parts.append(_subdomain(gen, recipe["n_subdomain"], recipe["subdomain_k"], constant))
    if recipe.get("cascade_scenes", 0):
        parts.append(_cascade_tiles(gen, recipe["cascade_scenes"],
                                    recipe["cascade_tiles_per_level"], recipe["cascade_k"],
                                    recipe["cascade_finest"], recipe["cascade_coarsest"],
                                    recipe["cascade_tile"]))
    return {k: torch.cat([p[k] for p in parts]).contiguous() for k in parts[0]}
