"""One entry point over the Poisson solvers (port of ``solver/api.py``).

Every method solves the exact reference system ``diag(theta) L u = f``
(pointwise theta, truncated 5-point Laplacian, ``h = 1/(n-1)``).
"""

from __future__ import annotations

import torch

from superresolution_for_pdes_tpu_torch.solver.cg import solve_poisson_cg
from superresolution_for_pdes_tpu_torch.solver.dst import solve_poisson_dst
from superresolution_for_pdes_tpu_torch.solver.multigrid import (
    mg_preconditioner,
    solve_poisson_mg,
)


def solve_poisson(f: torch.Tensor, theta, method: str = "dst", **kwargs) -> torch.Tensor:
    """Solve ``diag(theta) L u = f`` on the last two axes (batched).

    ``theta`` is a tensor of ``f``'s shape, or anything that broadcasts to it.
    ``method``: ``"dst"`` (exact fast diagonalization, the default),
    ``"cg"``, ``"mgcg"`` (CG preconditioned by one V-cycle) or ``"mg"``
    (V-cycle iteration); ``kwargs`` go to that solver (``refine_iters``,
    ``tol``, ``max_iters``, ``precond``, ``n_cycles``, ...).
    """
    theta = torch.as_tensor(theta, dtype=f.dtype, device=f.device).broadcast_to(f.shape)
    if method == "dst":
        return solve_poisson_dst(f, theta, **kwargs)
    if method == "cg":
        return solve_poisson_cg(f, theta, **kwargs)
    if method == "mgcg":
        kwargs.setdefault("precond", mg_preconditioner)
        return solve_poisson_cg(f, theta, **kwargs)
    if method == "mg":
        return solve_poisson_mg(f, theta, **kwargs)
    raise ValueError(f"unknown solver method: {method!r}")
