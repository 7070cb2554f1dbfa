"""PyTorch port, ``ops/``: grid, align-corners resize, 5-point stencil and the
plain twins of the stencil kernels K2/K3 and of the fused pre-smooth and
residual, each against the JAX package (the
Pallas kernels in interpret mode, as ``tests/test_pallas_stencil.py`` runs
them; K1's twin is held in ``tests/test_torch_physics.py``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from superresolution_for_pdes_tpu.ops import grid as jgrid
from superresolution_for_pdes_tpu.ops import resize as jresize
from superresolution_for_pdes_tpu.ops import stencil as jstencil
from superresolution_for_pdes_tpu.ops.pallas_stencil import pallas_jacobi_smooth, pallas_residual
from superresolution_for_pdes_tpu_torch.ops import grid, resize, stencil
from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk

from torch_port_helpers import assert_rel_close, f32, np_


@pytest.mark.parametrize("n", [20, 40, 160])
def test_grid_and_forcing_match_jax(n):
    # both round i/(n-1) to float32; XLA's CPU division may be 1 ulp off
    assert_rel_close(grid.make_grid(n), jgrid.make_grid(n), 1.2e-7, "grid")
    assert grid.grid_spacing(n) == jgrid.grid_spacing(n)
    ours = grid.forcing_term(10.37, 3.5, n)
    ref = jgrid.forcing_term(jnp.float32(10.37), jnp.float32(3.5), n)
    # a 1-ulp grid difference moves the phase 2 pi k x by up to ~4e-6
    assert_rel_close(ours, ref, 1e-5, "forcing")
    batched = grid.forcing_term(torch.tensor([10.37, 2.0]), torch.tensor([3.5, 1.0]), n)
    assert batched.shape == (2, n, n)
    assert_rel_close(batched[0], ours, 0, "batched forcing")


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("n", [20, 40, 160])
def test_resize_matches_jax_and_interpolate(n, method, rng):
    for out in (2 * n, n // 2 + 3):  # float64 builders, vectorized vs per-row
        np.testing.assert_allclose(resize.resize_matrix_np(n, out, method),
                                   jresize._resize_matrix_np(n, out, method), rtol=0, atol=1e-14)
    x = f32(rng, 2, 3, n, n)
    ours = resize.resize_align_corners(torch.from_numpy(x), (2 * n, 2 * n), method)
    ref = jresize.resize_align_corners(jnp.asarray(x), (2 * n, 2 * n), method)
    assert_rel_close(ours, ref, 1e-6, "vs jax")
    interp = F.interpolate(torch.from_numpy(x), size=(2 * n, 2 * n), mode=method,
                           align_corners=True)
    # F.interpolate forms its (bicubic) weights in float32
    assert_rel_close(ours, interp, 5e-5, "vs F.interpolate")
    assert_rel_close(resize.upsample2x(torch.from_numpy(x), method), ours, 0, "upsample2x")


def test_downsample_stride_matches_jax(rng):
    x = f32(rng, 3, 41, 41)
    np.testing.assert_array_equal(np_(resize.downsample_stride(torch.from_numpy(x), 2)),
                                  np_(jresize.downsample_stride(jnp.asarray(x), 2)))


@pytest.mark.parametrize("n", [20, 40, 160])
def test_stencil_matches_jax(n, rng):
    u, theta, f = f32(rng, 2, n, n), f32(rng, 2, n, n, lo=0.5, hi=2.0), f32(rng, 2, n, n)
    tu, tt, tf = map(torch.from_numpy, (u, theta, f))
    ju, jt, jf = map(jnp.asarray, (u, theta, f))
    np.testing.assert_array_equal(np_(stencil.shift_sum(tu)), np_(jstencil.shift_sum(ju)))
    assert_rel_close(stencil.apply_laplacian(tu), jstencil.apply_laplacian(ju), 1e-6, "L u")
    assert_rel_close(stencil.apply_operator(tt, tu), jstencil.apply_operator(jt, ju), 1e-6,
                     "A u")
    assert_rel_close(stencil.residual(tt, tu, tf), jstencil.residual(jt, ju, jf), 1e-6,
                     "f - A u")


@pytest.mark.parametrize("n", [20, 41])
@pytest.mark.parametrize("field_theta", [False, True])
def test_residual_twin_matches_pallas(n, field_theta, rng):
    u, f = f32(rng, 3, n, n), f32(rng, 3, n, n)
    theta = f32(rng, 3, n, n, lo=0.5, hi=2.0) if field_theta else np.float32(-1.0)
    ref = pallas_residual(jnp.broadcast_to(jnp.asarray(theta), u.shape), jnp.asarray(u),
                          jnp.asarray(f), interpret=True)
    t_theta = torch.from_numpy(theta) if field_theta else -1.0
    ours = sk.plain_residual(t_theta, torch.from_numpy(u), torch.from_numpy(f))
    assert_rel_close(ours, ref, 1e-6, "K2 twin")


@pytest.mark.parametrize("n", [20, 41])
@pytest.mark.parametrize("iters", [1, 2, 3, 4, 6])
def test_jacobi_twin_matches_pallas(n, iters, rng):
    u, b = f32(rng, 2, n, n), f32(rng, 2, n, n)
    ref = pallas_jacobi_smooth(jnp.asarray(u), jnp.asarray(b), iters=iters, interpret=True)
    ours = sk.plain_jacobi_smooth(torch.from_numpy(u), torch.from_numpy(b), iters=iters)
    assert_rel_close(ours, ref, 1e-6, "K3 twin")


@pytest.mark.parametrize("n", [20, 41])
@pytest.mark.parametrize("iters", [0, 1, 2, 3, 5])
def test_smooth_residual_twin_matches_pallas(n, iters, rng):
    """The V-cycle's finest level as the JAX package runs it: K3, then K2 with
    theta = -1 on the smoothed u."""
    u, b = f32(rng, 2, n, n), f32(rng, 2, n, n)
    ref_u = pallas_jacobi_smooth(jnp.asarray(u), jnp.asarray(b), iters=iters, interpret=True)
    ref_r = pallas_residual(jnp.full_like(ref_u, -1.0), ref_u, jnp.asarray(b), interpret=True)
    ours_u, ours_r = sk.plain_smooth_residual(torch.from_numpy(u), torch.from_numpy(b),
                                              iters=iters)
    assert_rel_close(ours_u, ref_u, 1e-6, "smoothed u")
    assert_rel_close(ours_r, ref_r, 1e-6, "residual")


def test_cpu_wrappers_run_twins_and_count_nothing(rng):
    sk.reset_launch_counts()
    u, f = torch.from_numpy(f32(rng, 2, 3, 20, 20)), torch.from_numpy(f32(rng, 2, 3, 20, 20))
    theta = torch.from_numpy(f32(rng, 2, 3, 20, 20, lo=0.5, hi=2.0))
    for th in (-1.0, torch.tensor(-1.0), theta):
        assert torch.equal(sk.kernel_residual(th, u, f, h=0.05),
                           sk.plain_residual(th, u, f, h=0.05))
        assert torch.equal(sk.kernel_apply_operator(th, u, h=0.05),
                           sk.plain_apply_operator(th, u, h=0.05))
    for iters in (0, 2, 5):
        assert torch.equal(sk.kernel_jacobi_smooth(u, f, iters=iters, omega=0.7),
                           sk.plain_jacobi_smooth(u, f, iters=iters, omega=0.7))
    for iters in (0, 2, 3, 5):
        got = sk.kernel_smooth_residual(u, f, h=0.05, omega=0.7, iters=iters)
        ref = sk.plain_smooth_residual(u, f, h=0.05, omega=0.7, iters=iters)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert set(sk.launch_counts()) == {fn.__name__ for fn in sk.KERNELS}
    assert sum(sk.launch_counts().values()) == 0


def test_wrappers_reject_bad_shapes(rng):
    u = torch.from_numpy(f32(rng, 2, 20, 20))
    with pytest.raises(ValueError):
        sk.kernel_residual(-1.0, u, u[:1])
    with pytest.raises(ValueError):
        sk.kernel_residual(u[0], u, u)
    with pytest.raises(ValueError):
        sk.kernel_jacobi_smooth(u[..., :19], u[..., :19])
    with pytest.raises(ValueError):
        sk.kernel_jacobi_smooth(u, u, iters=-1)
    with pytest.raises(ValueError):
        sk.kernel_smooth_residual(u, u[:1])
    with pytest.raises(ValueError):
        sk.kernel_smooth_residual(u[..., :19], u[..., :19])
    with pytest.raises(ValueError):
        sk.kernel_smooth_residual(u, u, iters=-1)
