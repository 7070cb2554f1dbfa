"""PyTorch port, ``solver/``: the DST solver against scipy (float64) and JAX
(float32), the Galerkin V-cycle / multigrid solve against JAX, with the
finest-level stencil kernels' wiring on (their plain twins on the CPU) and
off, lock-step CG (plain and multigrid-preconditioned) and ``solve_poisson``
against JAX in float64."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from superresolution_for_pdes_tpu.ops import stencil as jstencil
from superresolution_for_pdes_tpu.solver import api as japi
from superresolution_for_pdes_tpu.solver import cg as jcg
from superresolution_for_pdes_tpu.solver import dst as jdst
from superresolution_for_pdes_tpu.solver import multigrid as jmg
from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
from superresolution_for_pdes_tpu_torch.solver import cg, dst, multigrid, solve_poisson

from torch_port_helpers import assert_rel_close, f32


def _problem(n, rng, dtype=np.float32):
    x = np.linspace(0.0, 1.0, n)
    f = np.sin(2 * np.pi * 1.7 * x)[None, :] * np.sin(2 * np.pi * 2.3 * x)[:, None]
    theta = rng.uniform(0.5, 2.0, size=(n, n))
    return f.astype(dtype), theta.astype(dtype)


def test_dst_float64_matches_scipy(rng, reference_solve):
    f, theta = _problem(40, rng, np.float64)
    ours = dst.solve_poisson_dst(torch.from_numpy(f), torch.from_numpy(theta)).numpy()
    assert np.max(np.abs(ours - reference_solve(f, theta))) <= 1e-6


@pytest.mark.parametrize("n", [40, 640])
def test_dst_float32_matches_jax(n, rng):
    f, theta = _problem(n, rng)
    ours = dst.solve_poisson_dst(torch.from_numpy(f), torch.from_numpy(theta), refine_iters=1)
    ref = jdst.solve_poisson_dst(jnp.asarray(f), jnp.asarray(theta), refine_iters=1)
    assert_rel_close(ours, ref, 1e-5, f"dst n={n}")


def test_sine_basis_and_eigenvalues_match_jax():
    for n in (7, 40):
        np.testing.assert_array_equal(dst.sine_basis(n).numpy(), np.asarray(jdst.sine_basis(n)))
        np.testing.assert_array_equal(dst.laplacian_eigenvalues(n).numpy(),
                                      np.asarray(jdst.laplacian_eigenvalues(n)))


@pytest.mark.parametrize("n", [40, 160])
@pytest.mark.parametrize("kernels", [False, True])
def test_vcycle_matches_jax(n, kernels, rng):
    f, theta = _problem(n, rng)
    b = -(f / theta)
    u0 = 0.01 * f32(rng, 2, n, n)
    b2 = np.stack([b, 0.5 * b])
    ref = jmg.vcycle(jnp.asarray(u0), jnp.asarray(b2), use_pallas=kernels)
    sk.reset_launch_counts()
    ours = multigrid.vcycle(torch.from_numpy(u0), torch.from_numpy(b2), use_kernels=kernels)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)
    assert sum(sk.launch_counts().values()) == 0  # CPU tensors run the twins


def test_vcycle_kernel_wiring_matches_dense_path(rng):
    """Twins at the finest level reproduce the dense Jacobi/residual path."""
    f, theta = _problem(160, rng)
    b = torch.from_numpy(-(f / theta))
    u0 = torch.zeros_like(b)
    dense = multigrid.vcycle(u0, b, use_kernels=False)
    fused = multigrid.vcycle(u0, b, use_kernels=True)
    np.testing.assert_allclose(fused.numpy(), dense.numpy(), rtol=1e-5, atol=1e-7)
    # CPU tensors keep the dense path by default (None -> CUDA and n >= 160)
    assert torch.equal(multigrid.vcycle(u0, b), dense)


def test_mg_solve_matches_jax_at_160(rng):
    f, theta = _problem(160, rng)
    ref = jmg.solve_poisson_mg(jnp.asarray(f), jnp.asarray(theta), n_cycles=6)
    for kernels in (False, True):
        ours = multigrid.solve_poisson_mg(torch.from_numpy(f), torch.from_numpy(theta),
                                          n_cycles=6, use_kernels=kernels)
        assert_rel_close(ours, ref, 1e-5, f"mg kernels={kernels}")
    pre = multigrid.mg_preconditioner(torch.from_numpy(f))
    assert_rel_close(pre, jmg.mg_preconditioner(jnp.asarray(f)), 1e-5, "preconditioner")


def test_mg_converges_to_dst(rng):
    f, theta = _problem(40, rng, np.float64)
    tf, tt = torch.from_numpy(f), torch.from_numpy(theta)
    exact = dst.solve_poisson_dst(tf, tt)
    ours = multigrid.solve_poisson_mg(tf, tt, n_cycles=25)
    assert torch.max(torch.abs(ours - exact)) <= 1e-6


# ------------------------------------------------------------------------ CG
# float64: the port's CG matvec is K1's twin, which takes h^2 rounded to
# float32 as the Pallas kernel does (a 3e-8 relative change of the operator);
# JAX's CG runs the XLA stencil with h^2 in float64
CG_REL = 1e-7


def _cg_batch(n, rng):
    """Three float64 problems: f = 0 (converged before the first iteration:
    the tiny ||b|| floor and the pAp = 0 and rz = 0 guards), a DST eigenmode
    of L with theta = 1 (plain CG converges in one iteration), and a random
    forcing with random theta."""
    i = np.arange(1, n + 1)
    mode = np.sin(np.pi * i / (n + 1))[:, None] * np.sin(2 * np.pi * i / (n + 1))[None, :]
    f = np.stack([np.zeros((n, n)), mode, rng.standard_normal((n, n))])
    theta = np.stack([np.ones((n, n)), np.ones((n, n)), rng.uniform(0.5, 2.0, (n, n))])
    return f, theta


def _port_cg(b, **kw):
    calls = []

    def matvec(p):
        calls.append(1)
        return sk.kernel_apply_operator(-1.0, p)

    u, iters = cg.cg_solve(matvec, torch.from_numpy(b), **kw)
    return u, int(iters), len(calls)


@pytest.mark.parametrize("n", [20, 41])
@pytest.mark.parametrize("precond", [False, True])
def test_cg_matches_jax_and_freezes_converged_elements(n, precond, rng):
    f, theta = _cg_batch(n, rng)
    b = -(f / theta)
    kw = dict(tol=1e-8, max_iters=500)
    jpre, tpre = (jmg.mg_preconditioner, multigrid.mg_preconditioner) if precond else (None, None)

    def jmatvec(u):
        return -jstencil.apply_laplacian(u)

    ju, jit = jcg.cg_solve(jmatvec, jnp.asarray(b), precond=jpre, **kw)
    u, iters, matvecs = _port_cg(b, precond=tpre, **kw)
    assert iters == int(jit)
    assert matvecs == 1 + cg.iterations_run(iters, kw["max_iters"],
                                            cg.convergence_chunk(tpre))
    assert_rel_close(u, ju, CG_REL, "cg_solve")
    # the batch runs until its slowest element converges; the others stay frozen
    alone = [int(jcg.cg_solve(jmatvec, jnp.asarray(b[k:k + 1]), precond=jpre, **kw)[1])
             for k in range(3)]
    assert alone[0] == 0 and iters == max(alone) > min(alone[1:]) - 1
    for k in range(3):
        assert_rel_close(u[k], _port_cg(b[k:k + 1], precond=tpre, **kw)[0][0], CG_REL,
                         f"element {k} alone")
    assert not torch.any(u[0])
    ref = jcg.solve_poisson_cg(jnp.asarray(f), jnp.asarray(theta), precond=jpre, **kw)
    ours = cg.solve_poisson_cg(torch.from_numpy(f), torch.from_numpy(theta), precond=tpre, **kw)
    assert_rel_close(ours, ref, CG_REL, "solve_poisson_cg")


@pytest.mark.parametrize("precond", [False, True])
def test_cg_convergence_chunk_gives_the_same_bits(precond, rng, monkeypatch):
    assert cg.convergence_chunk(None) == cg.CONVERGENCE_CHUNK
    assert cg.convergence_chunk(multigrid.mg_preconditioner) == 1
    f, theta = _cg_batch(41, rng)
    b = -(f / theta)
    pre = multigrid.mg_preconditioner if precond else None
    u, iters, _ = _port_cg(b, tol=1e-8, precond=pre)
    for chunk in (1, 3, 8):
        monkeypatch.setattr(cg, "convergence_chunk", lambda precond, chunk=chunk: chunk)
        u_c, iters_c, matvecs = _port_cg(b, tol=1e-8, precond=pre)
        assert torch.equal(u_c, u) and iters_c == iters
        assert matvecs == 1 + cg.iterations_run(iters, 5000, chunk)
    # a cap below one chunk: the loop stops at max_iters, as JAX's does
    u5, iters5, matvecs5 = _port_cg(b, tol=1e-8, max_iters=5, precond=pre)
    ju5, jit5 = jcg.cg_solve(lambda x: -jstencil.apply_laplacian(x), jnp.asarray(b), tol=1e-8,
                             max_iters=5, precond=jmg.mg_preconditioner if precond else None)
    assert iters5 == int(jit5) == 5 and matvecs5 == 6
    assert_rel_close(u5, ju5, CG_REL, "capped")


@pytest.mark.parametrize("method,kw", [
    ("dst", {"refine_iters": 1}), ("cg", {"tol": 1e-10}), ("mgcg", {"tol": 1e-10}),
    ("mg", {"n_cycles": 8})])
def test_solve_poisson_matches_jax(method, kw, rng):
    f, theta = _problem(41, rng, np.float64)
    ref = japi.solve_poisson(jnp.asarray(f), jnp.asarray(theta), method=method, **kw)
    ours = solve_poisson(torch.from_numpy(f), torch.from_numpy(theta), method=method, **kw)
    assert_rel_close(ours, ref, CG_REL, method)
    # theta as a scalar broadcasts to f's shape
    ref = japi.solve_poisson(jnp.asarray(f), 1.5, method=method, **kw)
    assert_rel_close(solve_poisson(torch.from_numpy(f), 1.5, method=method, **kw), ref, CG_REL,
                     f"{method} scalar theta")


def test_solve_poisson_rejects_an_unknown_method():
    with pytest.raises(ValueError, match="unknown solver method"):
        solve_poisson(torch.zeros(8, 8), 1.0, method="lu")
