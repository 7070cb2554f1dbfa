"""Discrete PDE-residual loss on the predicted fine grid (port of
``physics/loss.py``).

    L_pde = mean( ((diag(theta) L u_pred - f) / f_std)^2 )

on the denormalized prediction, with the truncated 5-point ``L`` the training
data was generated from. ``theta * (L u)`` is the hand-written kernel K1
(:func:`~superresolution_for_pdes_tpu_torch.ops.stencil_kernels.kernel_apply_operator`)
inside a ``torch.autograd.Function``: the truncated ``L`` is symmetric, so the
gradient with respect to ``u`` of ``<g, theta * L u>`` is ``L (theta * g)``,
which is K1 again with scalar ``theta = 1``. theta and f are data and get no
gradient.
"""

from __future__ import annotations

import torch

from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
from superresolution_for_pdes_tpu_torch.ops.stencil_kernels import (
    kernel_apply_operator,
    plain_apply_operator,
)


class _ApplyOperator(torch.autograd.Function):
    """``theta * (L u)`` with the gradient ``L (theta * g)`` for ``u``."""

    @staticmethod
    def forward(ctx, theta: torch.Tensor, u: torch.Tensor, use_kernel: bool) -> torch.Tensor:
        if theta.requires_grad:
            raise ValueError("pde_residual_loss: theta is data and takes no gradient")
        theta = theta.contiguous()
        ctx.save_for_backward(theta)
        ctx.op = kernel_apply_operator if use_kernel else plain_apply_operator
        return ctx.op(theta, u.contiguous())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (theta,) = ctx.saved_tensors
        return None, ctx.op(1.0, (theta * grad).contiguous()), None


def apply_operator(theta: torch.Tensor, u: torch.Tensor,
                   use_kernel: bool | None = None) -> torch.Tensor:
    """Differentiable ``theta * (L u)`` over the last two axes.

    ``use_kernel``: ``None`` or ``True`` runs K1 (its plain twin for a CPU
    tensor), ``False`` the plain twin on any device.
    """
    return _ApplyOperator.apply(theta, u, use_kernel is not False)


def pde_residual_loss(pred_norm: torch.Tensor, theta_fine: torch.Tensor, f_fine: torch.Tensor,
                      stats: NormStats, use_kernel: bool | None = None) -> torch.Tensor:
    """Mean squared normalized PDE residual of a normalized NCHW prediction.

    Args:
        pred_norm: model output ``(B, 1, H, W)`` in normalized space.
        theta_fine / f_fine: physical-scale coefficient and forcing ``(B, H, W)``.
        stats: normalization statistics, 0-d or ``(B, 1, 1)``.
        use_kernel: as in :func:`apply_operator`.
    """
    u_pred = stats.denormalize_u(pred_norm[:, 0])
    resid = (apply_operator(theta_fine, u_pred, use_kernel) - f_fine) / stats.f_std
    return torch.mean(resid ** 2)
