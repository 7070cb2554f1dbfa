"""Galerkin geometric multigrid V-cycle (port of ``solver/multigrid.py``).

Solves ``(-L) u = b`` (``b = -f/theta`` for ``diag(theta) L u = f``). Each
level keeps its operator in the separable form ``A U = B U D^T + D U B^T``;
coarse operators are Galerkin products with the align-corners linear
interpolation ``P`` (``B' = P^T B P``, ``D' = P^T D P``); smoothing is weighted
Jacobi (omega = 0.8) with the exact Galerkin diagonal; the coarsest level
(<= 10 x 10) is a dense inverse. The hierarchy is built in float64 numpy and
cached, and its on-device fp32 tensors are cached per (n, dtype, device).

At the finest level ``B = -tridiag(1, -2, 1)/h^2`` and ``D = I``, so smoothing
and the residual are 5-point stencil work: with ``use_kernels`` the V-cycle
runs them as the hand-written kernels of
:mod:`~superresolution_for_pdes_tpu_torch.ops.stencil_kernels`: the
pre-smoothing and the residual (K3 then K2 with a scalar ``theta = -1``) in
one launch, and K3 for the post-smoothing. On a CPU
tensor those wrappers run their plain twins, so ``use_kernels=True`` on the
CPU exercises the same wiring.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from superresolution_for_pdes_tpu_torch.ops.resize import resize_matrix_np
from superresolution_for_pdes_tpu_torch.ops.stencil_kernels import (
    kernel_jacobi_smooth,
    kernel_smooth_residual,
)
from superresolution_for_pdes_tpu_torch.utils.profiling import span


@functools.lru_cache(maxsize=None)
def _level_sizes(n: int, coarsest: int = 10) -> tuple[int, ...]:
    sizes = [n]
    while sizes[-1] > coarsest:
        sizes.append((sizes[-1] + 1) // 2)
    return tuple(sizes)


@functools.lru_cache(maxsize=None)
def _hierarchy_np(n: int, coarsest: int = 10):
    """Per-level ``(B, D, diagA, P)`` and the coarsest dense inverse, float64."""
    sizes = _level_sizes(n, coarsest)
    h = 1.0 / (n - 1)
    T = np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1)
    B = -T / (h * h)
    D = np.eye(n)
    levels = []
    for lvl, nl in enumerate(sizes):
        diagA = np.outer(np.diag(B), np.diag(D)) + np.outer(np.diag(D), np.diag(B))
        if lvl < len(sizes) - 1:
            P = resize_matrix_np(sizes[lvl + 1], nl, "bilinear")  # (n_fine, n_coarse)
            levels.append((B, D, diagA, P))
            B = P.T @ B @ P
            D = P.T @ D @ P
        else:
            levels.append((B, D, diagA, None))
    A_inv = np.linalg.inv(np.kron(B, D) + np.kron(D, B))
    return sizes, levels, A_inv


@functools.lru_cache(maxsize=None)
def _hierarchy(n: int, omega: float, dtype, device):
    """The hierarchy as tensors: per level ``(B, D, omega/diagA, P)`` and the
    coarsest inverse."""
    sizes, levels, A_inv = _hierarchy_np(n)

    def t(x):
        return None if x is None else torch.as_tensor(x, dtype=dtype, device=device)

    return sizes, [(t(B), t(D), t(omega / dA), t(P)) for B, D, dA, P in levels], t(A_inv)


def _apply_A(B, D, u):
    """``A u = B u D^T + D u B^T`` on the last two axes."""
    return torch.matmul(torch.matmul(B, u), D.T) + torch.matmul(torch.matmul(D, u), B.T)


def _vcycle(u, b, sizes, levels, A_inv, level, pre, post, omega, use_kernels):
    B, D, inv_diag, P = levels[level]
    if level == len(sizes) - 1:
        nC = sizes[-1]
        flat = b.reshape(b.shape[:-2] + (nC * nC,))
        return torch.matmul(flat, A_inv.T).reshape(b.shape)
    kernels = use_kernels and level == 0
    if kernels:
        u, r = kernel_smooth_residual(u, b, h=1.0 / (sizes[0] - 1), omega=omega, iters=pre)
    else:
        for _ in range(pre):
            u = u + inv_diag * (b - _apply_A(B, D, u))
        r = b - _apply_A(B, D, u)
    rc = torch.matmul(torch.matmul(P.T, r), P)  # P^T r P
    ec = _vcycle(torch.zeros_like(rc), rc, sizes, levels, A_inv, level + 1, pre, post,
                 omega, False)
    u = u + torch.matmul(torch.matmul(P, ec), P.T)  # P ec P^T
    if kernels:
        u = kernel_jacobi_smooth(u, b, h=1.0 / (sizes[0] - 1), omega=omega, iters=post)
    else:
        for _ in range(post):
            u = u + inv_diag * (b - _apply_A(B, D, u))
    return u


def vcycle(u: torch.Tensor, b: torch.Tensor, pre: int = 2, post: int = 2,
           omega: float = 0.8, use_kernels: bool | None = None) -> torch.Tensor:
    """One Galerkin V-cycle for ``(-L) u = b`` on the last two axes (batched).

    ``use_kernels`` runs the finest level's smoothing and residual on the
    stencil kernels (the pre-smooth fused with the residual, then K3). ``None`` enables them for CUDA tensors at
    ``n >= 160``, the switch the JAX package uses on the TPU.
    """
    with span("multigrid.vcycle"):
        n = b.shape[-1]
        if use_kernels is None:
            use_kernels = b.is_cuda and n >= 160
        sizes, levels, A_inv = _hierarchy(n, float(omega), b.dtype, b.device)
        u = u.contiguous()
        b = b.contiguous()
        return _vcycle(u, b, sizes, levels, A_inv, 0, pre, post, omega, use_kernels)


def mg_preconditioner(r: torch.Tensor, use_kernels: bool | None = None) -> torch.Tensor:
    """One zero-initialized V-cycle -- usable as a CG preconditioner."""
    return vcycle(torch.zeros_like(r), r, use_kernels=use_kernels)


def solve_poisson_mg(f: torch.Tensor, theta: torch.Tensor, n_cycles: int = 12,
                     pre: int = 2, post: int = 2,
                     use_kernels: bool | None = None) -> torch.Tensor:
    """V-cycle iteration for ``diag(theta) L u = f`` on the last two axes."""
    b = -(f / theta)
    u = torch.zeros_like(b)
    for _ in range(n_cycles):
        u = vcycle(u, b, pre=pre, post=post, use_kernels=use_kernels)
    return u
