"""Batched Poisson solvers for ``diag(theta) L u = f`` (port of ``solver/``):
exact DST fast diagonalization (:mod:`.dst`), lock-step conjugate gradients
(:mod:`.cg`), the Galerkin V-cycle (:mod:`.multigrid`) and the
``solve_poisson`` entry point over them (:mod:`.api`)."""

from superresolution_for_pdes_tpu_torch.solver.api import solve_poisson  # noqa: F401
from superresolution_for_pdes_tpu_torch.solver.cg import solve_poisson_cg  # noqa: F401
from superresolution_for_pdes_tpu_torch.solver.dst import solve_poisson_dst  # noqa: F401
from superresolution_for_pdes_tpu_torch.solver.multigrid import solve_poisson_mg  # noqa: F401
