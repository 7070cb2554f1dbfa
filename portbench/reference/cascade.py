"""Plain-PyTorch cascade of one scene, written from its description: per
level ``r -> 2r``, non-overlapping tiles, per-tile self-normalisation, the
model input ``[u_up, theta, f, log u_std / 10, log f_std / 10]``, one model
call over the tiles, denormalisation, stitching, optional Galerkin V-cycles
of ``diag(theta) L u = f``, and the level's modal gains applied in the DST-I
basis -- in that order.

Departures from the program, of arithmetic only: tiles are cut and stitched
by slicing in Python loops, the coarse tile is upsampled with
``F.interpolate`` (the program multiplies by interpolation matrices), the
V-cycle's finest level runs its smoothing and residual as dense separable
products (the program runs the stencil kernels K2/K3 there), and one scene
runs at a time. Float32 throughout unless a caller passes float64; the
hierarchy and the sine basis are built in float64 numpy.

Nothing here imports the program.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

STD_FLOOR = 1e-20
THETA_CONSTANT_TOL = 1e-6
LOG_EPS = 1e-30
N_OCTAVES = 12


# ------------------------------------------------------------- DST-I basis
@functools.lru_cache(maxsize=None)
def sine_basis_np(n: int) -> np.ndarray:
    """Orthogonal DST-I basis ``S[j, k] = sqrt(2/(n+1)) sin(pi (j+1)(k+1)/(n+1))``."""
    j = np.arange(1, n + 1, dtype=np.float64)
    return np.sin(np.pi * np.outer(j, j) / (n + 1)) * np.sqrt(2.0 / (n + 1))


def dst2(x: torch.Tensor) -> torch.Tensor:
    S = torch.as_tensor(sine_basis_np(x.shape[-1]), dtype=x.dtype, device=x.device)
    return S @ x @ S


def solve_poisson(f: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Exact solve of ``theta * L u = f`` (5-point ``L``, zero Dirichlet
    values outside the ``n x n`` vertex grid, ``h = 1/(n-1)``) by the DST-I;
    pass float64 for a solve exact to rounding."""
    n = f.shape[-1]
    k = np.arange(1, n + 1, dtype=np.float64)
    lam = -4.0 * np.sin(np.pi * k / (2.0 * (n + 1))) ** 2
    h = 1.0 / (n - 1)
    den = torch.as_tensor((lam[:, None] + lam[None, :]) / (h * h), dtype=f.dtype,
                          device=f.device)
    return dst2(dst2(f / theta) / den)


def modal_gain_field(gains: torch.Tensor, n: int) -> torch.Tensor:
    """The ``(n, n)`` per-mode gains of a 2-d log-octave grid of gains: mode
    ``(i, j)`` (1-based) takes ``gains[band(i), band(j)]``, ``band(i) =
    clip(floor(bpo * log2 i), 0, 12 bpo - 1)``."""
    bpo = gains.shape[0] // N_OCTAVES
    i = np.arange(1, n + 1)
    band = np.clip((bpo * np.log2(i)).astype(np.int64), 0, N_OCTAVES * bpo - 1)
    idx = torch.as_tensor(band, device=gains.device)
    return gains[idx[:, None], idx[None, :]]


def modal_correction(field: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    return dst2(dst2(field) * modal_gain_field(gains, field.shape[-1]).to(field.dtype))


# ------------------------------------------------------------------ tiles
def split(field: torch.Tensor, t: int) -> torch.Tensor:
    n = field.shape[-1] // t
    return torch.stack([field[i * t:(i + 1) * t, j * t:(j + 1) * t]
                        for i in range(n) for j in range(n)])


def stitch(tiles: torch.Tensor) -> torch.Tensor:
    n = int(round(tiles.shape[0] ** 0.5))
    return torch.cat([torch.cat(list(tiles[i * n:(i + 1) * n]), dim=1) for i in range(n)], dim=0)


def _mean_std(x: torch.Tensor):
    mean = x.mean(dim=(-2, -1), keepdim=True)
    std = x.std(dim=(-2, -1), correction=1, keepdim=True)
    return mean, std


def model_inputs(u_c: torch.Tensor, f: torch.Tensor, theta: torch.Tensor,
                 scale_channels: bool, stats: Dict | None = None):
    """``(x, stats)``: the normalised NCHW input of ``(T, t, t)`` coarse u and
    ``(T, 2t, 2t)`` f and theta, per tile (``stats=None``) or with the given
    statistics (0-d or per tile)."""
    if stats is None:
        u_mean, u_std = _mean_std(u_c)
        f_mean, f_std = _mean_std(f)
        t_mean, t_std = _mean_std(theta)
        stats = {"u_mean": u_mean, "u_std": u_std.clamp(min=STD_FLOOR), "f_mean": f_mean,
                 "f_std": f_std.clamp(min=STD_FLOOR),
                 "theta_mean": torch.where(t_std < THETA_CONSTANT_TOL, 0.0, t_mean),
                 "theta_std": torch.where(t_std < THETA_CONSTANT_TOL, 1.0,
                                          t_std.clamp(min=STD_FLOOR))}
    fine = f.shape[-1]
    u_n = ((u_c - stats["u_mean"]) / stats["u_std"])[:, None]
    u_up = F.interpolate(u_n, size=(fine, fine), mode="bilinear", align_corners=True)[:, 0]
    chans = [u_up, (theta - stats["theta_mean"]) / stats["theta_std"],
             (f - stats["f_mean"]) / stats["f_std"]]
    if scale_channels:
        for key in ("u_std", "f_std"):
            chans.append(torch.broadcast_to(torch.log(stats[key] + LOG_EPS) / 10.0, f.shape))
    return torch.stack(chans, dim=1), stats


# --------------------------------------------------------------- V-cycle
def _interp_matrix(n_coarse: int, n_fine: int) -> np.ndarray:
    """``(n_fine, n_coarse)`` align-corners linear interpolation, float64."""
    src = np.arange(n_fine, dtype=np.float64) * ((n_coarse - 1) / (n_fine - 1))
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_coarse - 1)
    hi = np.minimum(lo + 1, n_coarse - 1)
    w = src - lo
    P = np.zeros((n_fine, n_coarse))
    rows = np.arange(n_fine)
    np.add.at(P, (rows, lo), 1.0 - w)
    np.add.at(P, (rows, hi), w)
    return P


@functools.lru_cache(maxsize=None)
def _hierarchy_np(n: int, omega: float, coarsest: int = 10):
    """Galerkin levels ``[(B, D, omega / diag A, P)]`` of ``A u = B u D^T +
    D u B^T`` from the finest ``B = -tridiag(1, -2, 1)/h^2``, ``D = I``, and
    the coarsest level's dense inverse."""
    sizes = [n]
    while sizes[-1] > coarsest:
        sizes.append((sizes[-1] + 1) // 2)
    h = 1.0 / (n - 1)
    B = (2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)) / (h * h)
    D = np.eye(n)
    levels = []
    for lvl, nl in enumerate(sizes):
        diag = np.outer(np.diag(B), np.diag(D)) + np.outer(np.diag(D), np.diag(B))
        P = _interp_matrix(sizes[lvl + 1], nl) if lvl < len(sizes) - 1 else None
        levels.append((B, D, omega / diag, P))
        if P is not None:
            B, D = P.T @ B @ P, P.T @ D @ P
    A_inv = np.linalg.inv(np.kron(B, D) + np.kron(D, B))
    return levels, A_inv


def vcycle(u: torch.Tensor, b: torch.Tensor, pre: int = 2, post: int = 2,
           omega: float = 0.8) -> torch.Tensor:
    """One Galerkin V-cycle for ``(-L) u = b`` with weighted Jacobi."""
    levels_np, A_inv_np = _hierarchy_np(b.shape[-1], omega)

    def t(a):
        return None if a is None else torch.as_tensor(a, dtype=b.dtype, device=b.device)

    levels = [tuple(t(a) for a in lvl) for lvl in levels_np]
    A_inv = t(A_inv_np)

    def apply_A(B, D, x):
        return B @ x @ D.T + D @ x @ B.T

    def cycle(x, rhs, lvl):
        B, D, inv_diag, P = levels[lvl]
        if P is None:
            m = rhs.shape[-1]
            return (A_inv @ rhs.reshape(m * m)).reshape(m, m)
        for _ in range(pre):
            x = x + inv_diag * (rhs - apply_A(B, D, x))
        r = rhs - apply_A(B, D, x)
        e = cycle(torch.zeros(P.shape[1], P.shape[1], dtype=b.dtype, device=b.device),
                  P.T @ r @ P, lvl + 1)
        x = x + P @ e @ P.T
        for _ in range(post):
            x = x + inv_diag * (rhs - apply_A(B, D, x))
        return x

    return cycle(u, b, 0)


# --------------------------------------------------------------- cascade
def cascade(model: Callable[[torch.Tensor], torch.Tensor], u0: torch.Tensor,
            f: Dict[int, torch.Tensor], theta: Dict[int, torch.Tensor], target: int,
            tiles: Sequence[int], gains: Sequence[torch.Tensor] | None,
            refine_cycles: int, scale_channels: bool = True,
            level_models: Sequence[Callable] | None = None,
            refine: Dict | None = None) -> Dict[int, torch.Tensor]:
    """Every level's field of one scene from ``u0`` (``(r0, r0)``) to
    ``target``; ``level_models[i]`` (default ``model``) runs level ``i``;
    ``refine`` holds the V-cycle's ``pre_sweeps``, ``post_sweeps`` and
    ``omega`` (default 2, 2, 0.8)."""
    refine = refine or {}
    sweeps = (refine.get("pre_sweeps", 2), refine.get("post_sweeps", 2), refine.get("omega", 0.8))
    current, out, res, i = u0, {}, u0.shape[-1], 0
    while res < target:
        nxt, t = 2 * res, tiles[min(i, len(tiles) - 1)]
        run = model if level_models is None else level_models[min(i, len(level_models) - 1)]
        x, st = model_inputs(split(current, t), split(f[nxt], 2 * t), split(theta[nxt], 2 * t),
                             scale_channels)
        pred = run(x)[:, 0] * st["u_std"] + st["u_mean"]
        current = stitch(pred)
        if refine_cycles > 0:
            b = -(f[nxt] / theta[nxt])
            for _ in range(refine_cycles):
                current = vcycle(current, b, *sweeps)
        if gains is not None:
            current = modal_correction(current, gains[i])
        out[nxt] = current
        res, i = nxt, i + 1
    return out
