"""Batched conjugate gradients for ``diag(theta) L u = f`` (port of
``solver/cg.py``).

The system is solved as the SPD system ``A u = b`` with ``A = -L`` and
``b = -f / theta``. The whole batch advances in lock step: an element whose
relative residual is below ``tol`` gets step sizes 0 (alpha and beta), so its
``u`` and ``r`` stop changing, and the loop ends when no element is
unconverged or after ``max_iters`` iterations.

The JAX package runs the loop as a device ``while_loop``; here it is a Python
loop, and testing convergence on the host costs one device synchronisation.
So the host tests it before the first iteration and then every
:func:`convergence_chunk` iterations. Iterations past the point where every
element converged change nothing (alpha = beta = 0 leave ``u`` and ``r`` as
they are), so the result is the same, bit for bit, as with a test every
iteration; the count of iterations, kept on the device, adds one only while
some element is unconverged, so it equals the JAX package's. The loop never
runs past ``max_iters``.

:func:`solve_poisson_cg`'s matvec ``-L p`` is K1 with the scalar
``theta = -1`` (:func:`~superresolution_for_pdes_tpu_torch.ops.stencil_kernels.kernel_apply_operator`):
one launch per iteration and one for the initial residual on a CUDA tensor,
its plain twin on a CPU tensor. The batched dot products are plain torch, as
the JAX package computes them outside Pallas too.
"""

from __future__ import annotations

from typing import Callable

import torch

from superresolution_for_pdes_tpu_torch.ops.stencil_kernels import kernel_apply_operator

CONVERGENCE_CHUNK = 8  # iterations between two host tests, without a preconditioner


def convergence_chunk(precond) -> int:
    """Iterations between two host tests of convergence. Without a
    preconditioner an iteration is a few launches and costs about what a test
    costs, so :data:`CONVERGENCE_CHUNK` of them share one. With the V-cycle
    an iteration costs about 30 tests (an H100 at 640^2, PERF.md), more than
    the syncs a chunk saves, so every iteration is tested."""
    return CONVERGENCE_CHUNK if precond is None else 1


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched inner product over the last two (grid) axes."""
    return torch.sum(a * b, dim=(-2, -1))


def iterations_run(iters: int, max_iters: int, chunk: int) -> int:
    """How many loop iterations :func:`cg_solve` ran (and so how many matvecs
    after the first) when it returned ``iters``, testing every ``chunk``
    (:func:`convergence_chunk`): whole chunks, up to ``max_iters``."""
    return min(max_iters, -(-int(iters) // chunk) * chunk)


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    tol: float = 1e-10,
    max_iters: int = 5000,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Preconditioned CG on an SPD operator, batched over leading axes.

    Returns ``(u, iterations)``, the second a 0-d int32 tensor on ``b``'s
    device. ``tol`` is on the relative residual ``||b - A u|| / ||b||`` of each
    batch element.
    """
    if x0 is None:
        x0 = torch.zeros_like(b)

    b_norm2 = torch.clamp(_dot(b, b), min=torch.finfo(b.dtype).tiny)
    tol2 = (tol * tol) * b_norm2

    u = x0
    r = b - matvec(x0)
    z = r if precond is None else precond(r)
    p = z
    rz = _dot(r, z)
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    chunk = convergence_chunk(precond)
    done = 0
    while done < max_iters and bool(torch.any(_dot(r, r) > tol2)):
        steps = min(chunk, max_iters - done)
        for _ in range(steps):
            rr = _dot(r, r)
            it = it + torch.any(rr > tol2).to(torch.int32)
            Ap = matvec(p)
            pAp = _dot(p, Ap)
            converged = rr <= tol2
            alpha = torch.where(converged, 0.0, rz / torch.where(pAp == 0, 1.0, pAp))
            a = alpha[..., None, None]
            u = u + a * p
            r = r - a * Ap
            z = r if precond is None else precond(r)
            rz_new = _dot(r, z)
            beta = torch.where(converged, 0.0, rz_new / torch.where(rz == 0, 1.0, rz))
            p = z + beta[..., None, None] * p
            rz = rz_new
        done += steps
    return u, it


def solve_poisson_cg(
    f: torch.Tensor,
    theta: torch.Tensor,
    tol: float = 1e-10,
    max_iters: int = 5000,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    x0: torch.Tensor | None = None,
) -> torch.Tensor:
    """CG solve of ``diag(theta) L u = f`` on the last two axes (batched)."""
    b = -(f / theta)
    u, _ = cg_solve(lambda p: kernel_apply_operator(-1.0, p), b, x0=x0, tol=tol,
                    max_iters=max_iters, precond=precond)
    return u
