"""PyTorch port, K1 and ``physics/loss.py``: the plain twin of the
hand-written K1 kernel against the Pallas kernel (interpret mode), its
adjoint against ``jax.vjp`` of the JAX stencil, and the PDE-residual loss
and its gradient against the JAX loss; the fused loss kernels' twins (forward
and explicit backward) against ``jax.value_and_grad`` and against autograd."""

import dataclasses

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
from superresolution_for_pdes_tpu_torch.physics.loss import pde_residual_loss

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
    """The operator's gradient is the operator on ``theta * g`` (the truncated
    L is symmetric): K1's wrapper (``None``; its twin on a CPU tensor) and the
    twin (``False``) against ``jax.vjp``."""
    u, g = f32(rng, 4, 40, 40), f32(rng, 4, 40, 40)
    theta = f32(rng, 4, 40, 40, lo=0.5, hi=2.0)
    _, vjp = jax.vjp(lambda x: jstencil.apply_operator(jnp.asarray(theta), x), jnp.asarray(u))
    (ref,) = vjp(jnp.asarray(g))
    op = sk.plain_apply_operator if use_kernel is False else sk.kernel_apply_operator
    tt, tu, tg = torch.from_numpy(theta), torch.from_numpy(u), torch.from_numpy(g)
    assert_rel_close(op(1.0, tt * tg), ref, 1e-6, "L(theta g)")
    assert_rel_close(op(tt, tu), jstencil.apply_operator(jnp.asarray(theta), jnp.asarray(u)),
                     1e-6, "theta L u")


@pytest.mark.parametrize("n", [40, 41])
def test_apply_operator_is_self_adjoint(n, rng):
    """<L a, b> = <a, L b> for the truncated L, which the fused loss's
    backward relies on."""
    a, b = (torch.from_numpy(f32(rng, 3, n, n)).double() for _ in range(2))
    la, lb = sk.plain_apply_operator(1.0, a), sk.plain_apply_operator(1.0, b)
    left, right = float((la * b).sum()), float((a * lb).sum())
    assert abs(left - right) <= 1e-12 * float(la.norm() * b.norm())


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


def _loss_inputs(rng, b, n, per_sample):
    pred = f32(rng, b, 1, n, n)
    theta, f = f32(rng, b, n, n, lo=0.5, hi=2.0), f32(rng, b, n, n)
    ours_stats, ref_stats = _stats(rng, b, per_sample)
    return pred, theta, f, ours_stats, ref_stats


def _stat_args(stats):
    return stats.u_mean, stats.u_std, stats.f_std


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("n", [40, 41, 80])
def test_plain_pde_loss_and_backward_match_jax(n, b, per_sample, rng):
    """The fused kernels' twins (forward with its seed, explicit backward)
    against ``jax.value_and_grad`` of the JAX loss."""
    pred, theta, f, ours_stats, ref_stats = _loss_inputs(rng, b, n, per_sample)

    def jax_loss(p_nchw):
        return jax_pde_loss(jnp.moveaxis(p_nchw, 1, -1), jnp.asarray(theta), jnp.asarray(f),
                            ref_stats)

    ref_loss, ref_grad = jax.value_and_grad(jax_loss)(jnp.asarray(pred))
    loss, seed = sk.plain_pde_residual_loss(torch.from_numpy(pred), torch.from_numpy(theta),
                                            torch.from_numpy(f), *_stat_args(ours_stats))
    assert seed.shape == (b, n, n)
    grad = sk.plain_pde_residual_loss_backward(seed, ours_stats.u_std, torch.tensor(1.0))
    assert_rel_close(loss, ref_loss, 1e-5, "loss")
    assert_rel_close(grad.reshape(pred.shape), ref_grad, 1e-5, "gradient")


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("n", [40, 41])
def test_pde_loss_backward_matches_autograd(n, per_sample, rng):
    """The explicit backward ``u_std * L((2 g / N) * seed)`` against autograd
    through the plain loss."""
    pred, theta, f, ours_stats, _ = _loss_inputs(rng, 3, n, per_sample)
    tp = torch.from_numpy(pred).requires_grad_(True)
    loss, seed = sk.plain_pde_residual_loss(tp, torch.from_numpy(theta), torch.from_numpy(f),
                                            *_stat_args(ours_stats))
    g = torch.tensor(0.37)
    loss.backward(g)
    ours = sk.plain_pde_residual_loss_backward(seed.detach(), ours_stats.u_std, g)
    assert_rel_close(ours.reshape(tp.shape), tp.grad, 1e-6, "explicit backward")


def test_pde_residual_loss_on_cpu_counts_no_launch(rng):
    pred, theta, f, stats, _ = _loss_inputs(rng, 4, 40, True)
    tt, tf = torch.from_numpy(theta), torch.from_numpy(f)
    sk.reset_launch_counts()
    ref = sk.plain_pde_residual_loss(torch.from_numpy(pred), tt, tf, *_stat_args(stats))[0]
    for use_kernel in (None, True):
        tp = torch.from_numpy(pred).requires_grad_(True)
        loss = pde_residual_loss(tp, tt, tf, stats, use_kernel)
        loss.backward()
        assert torch.equal(loss.detach(), ref) and tp.grad.shape == tp.shape
        with torch.no_grad():
            assert torch.equal(pde_residual_loss(torch.from_numpy(pred), tt, tf, stats,
                                                 use_kernel), ref)
    assert sum(sk.launch_counts().values()) == 0


@pytest.mark.parametrize("name", ["theta", "f", "u_mean", "u_std", "f_std"])
def test_pde_residual_loss_rejects_data_gradients(name, rng):
    pred, theta, f, stats, _ = _loss_inputs(rng, 2, 20, True)
    data = {"theta": torch.from_numpy(theta), "f": torch.from_numpy(f)}
    if name in data:
        data[name].requires_grad_(True)
    else:
        stats = dataclasses.replace(stats, **{name: getattr(stats, name).requires_grad_(True)})
    with pytest.raises(ValueError, match=name):
        pde_residual_loss(torch.from_numpy(pred).requires_grad_(True), data["theta"], data["f"],
                          stats)
