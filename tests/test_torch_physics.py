"""PyTorch port, K1 and ``physics/loss.py``: the plain twin of the
hand-written K1 kernel against the Pallas kernel (interpret mode), its
backward against ``jax.vjp`` of the JAX stencil, and the PDE-residual loss
and its gradient against the JAX loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.data.normalization import NormStats as JaxNormStats
from superresolution_for_pdes_tpu.ops import stencil as jstencil
from superresolution_for_pdes_tpu.ops.pallas_stencil import pallas_apply_operator
from superresolution_for_pdes_tpu.physics.loss import pde_residual_loss as jax_pde_loss
from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
from superresolution_for_pdes_tpu_torch.physics.loss import apply_operator, pde_residual_loss

from torch_port_helpers import assert_rel_close, f32


@pytest.mark.parametrize("n", [20, 41])
@pytest.mark.parametrize("field_theta", [False, True])
def test_apply_operator_twin_matches_pallas(n, field_theta, rng):
    u = f32(rng, 3, n, n)
    theta = f32(rng, 3, n, n, lo=0.5, hi=2.0) if field_theta else np.float32(1.0)
    ref = pallas_apply_operator(jnp.asarray(theta), jnp.asarray(u), interpret=True)
    t_theta = torch.from_numpy(theta) if field_theta else 1.0
    ours = sk.plain_apply_operator(t_theta, torch.from_numpy(u))
    assert_rel_close(ours, ref, 1e-6, "K1 twin")
    sk.reset_launch_counts()
    # a CPU tensor runs the twin through the wrapper, and counts no launch
    assert torch.equal(sk.kernel_apply_operator(t_theta, torch.from_numpy(u)), ours)
    assert sk.launch_counts()["kernel_apply_operator"] == 0


@pytest.mark.parametrize("use_kernel", [None, False])
def test_apply_operator_backward_matches_jax_vjp(use_kernel, rng):
    u, g = f32(rng, 4, 40, 40), f32(rng, 4, 40, 40)
    theta = f32(rng, 4, 40, 40, lo=0.5, hi=2.0)
    _, vjp = jax.vjp(lambda x: jstencil.apply_operator(jnp.asarray(theta), x), jnp.asarray(u))
    (ref,) = vjp(jnp.asarray(g))
    tu = torch.from_numpy(u).requires_grad_(True)
    out = apply_operator(torch.from_numpy(theta), tu, use_kernel)
    out.backward(torch.from_numpy(g))
    assert_rel_close(tu.grad, ref, 1e-6, "L(theta g)")
    assert_rel_close(out, jstencil.apply_operator(jnp.asarray(theta), jnp.asarray(u)), 1e-6,
                     "theta L u")


def test_apply_operator_rejects_a_theta_gradient(rng):
    theta = torch.from_numpy(f32(rng, 2, 20, 20, lo=0.5, hi=2.0)).requires_grad_(True)
    with pytest.raises(ValueError, match="theta"):
        apply_operator(theta, torch.from_numpy(f32(rng, 2, 20, 20)))


def _stats(rng, b, per_sample):
    shape = (b, 1, 1) if per_sample else ()
    fields = dict(u_mean=f32(rng, *shape), u_std=f32(rng, *shape, lo=0.5, hi=2.0),
                  f_mean=f32(rng, *shape), f_std=f32(rng, *shape, lo=0.5, hi=2.0),
                  theta_mean=np.zeros(shape, np.float32), theta_std=np.ones(shape, np.float32))
    ours = NormStats(**{k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()},
                     theta_is_constant=torch.tensor(True))
    ref = JaxNormStats(**{k: jnp.asarray(v) for k, v in fields.items()},
                       theta_is_constant=jnp.asarray(True))
    return ours, ref


@pytest.mark.parametrize("per_sample", [False, True])
def test_pde_residual_loss_and_gradient_match_jax(per_sample, rng):
    b, n = 4, 40
    pred = f32(rng, b, 1, n, n)  # random: no cancellation hides an error
    theta, f = f32(rng, b, n, n, lo=0.5, hi=2.0), f32(rng, b, n, n)
    ours_stats, ref_stats = _stats(rng, b, per_sample)

    def jax_loss(p_nchw):
        return jax_pde_loss(jnp.moveaxis(p_nchw, 1, -1), jnp.asarray(theta), jnp.asarray(f),
                            ref_stats)

    ref_loss, ref_grad = jax.value_and_grad(jax_loss)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    loss = pde_residual_loss(tp, torch.from_numpy(theta), torch.from_numpy(f), ours_stats)
    loss.backward()
    assert_rel_close(loss, ref_loss, 1e-5, "loss")
    assert_rel_close(tp.grad, ref_grad, 1e-5, "gradient")
    # the twin path (use_kernel=False) is the same arithmetic on the CPU
    tp2 = torch.from_numpy(pred).requires_grad_(True)
    loss2 = pde_residual_loss(tp2, torch.from_numpy(theta), torch.from_numpy(f), ours_stats,
                              use_kernel=False)
    loss2.backward()
    assert torch.equal(loss2, loss) and torch.equal(tp2.grad, tp.grad)
