"""Discrete PDE-residual loss on the predicted fine grid (port of
``physics/loss.py``).

    L_pde = mean( ((diag(theta) L u_pred - f) / f_std)^2 )

on the denormalized prediction ``u_pred = pred * u_std + u_mean``, with the
truncated 5-point ``L`` the training data was generated from. The whole loss
is one call of the hand-written kernel K1 with the loss fused in
(:func:`~superresolution_for_pdes_tpu_torch.ops.stencil_kernels.kernel_pde_loss_forward`),
and its gradient one launch
(:func:`~superresolution_for_pdes_tpu_torch.ops.stencil_kernels.kernel_pde_loss_backward`):
the truncated ``L`` is symmetric, so the gradient with respect to ``pred`` is
``u_std * L((2 g / N) * theta * r / f_std)``. theta, f and the statistics are
data and get no gradient.

Under ``--dtype bfloat16`` the prediction, theta, f and per-sample statistics
arrive in bfloat16: the kernels' bf16 instantiations read them as they are,
compute in float32 and return a float32 loss, and the gradient comes back in
bfloat16, as the prediction's dtype.
"""

from __future__ import annotations

import torch

from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
from superresolution_for_pdes_tpu_torch.ops.stencil_kernels import (
    kernel_pde_loss_backward,
    kernel_pde_loss_forward,
    plain_pde_residual_loss,
    plain_pde_residual_loss_backward,
)
from superresolution_for_pdes_tpu_torch.utils.profiling import span


class _PdeResidualLoss(torch.autograd.Function):
    """The physics loss of ``pred``: one fused forward call, one backward
    launch."""

    @staticmethod
    def forward(ctx, pred, theta, f, u_mean, u_std, f_std, use_kernel: bool):
        forward = kernel_pde_loss_forward if use_kernel else plain_pde_residual_loss
        ctx.backward_fn = kernel_pde_loss_backward if use_kernel else plain_pde_residual_loss_backward
        loss, seed = forward(pred.contiguous(), theta, f, u_mean, u_std, f_std)
        ctx.save_for_backward(seed, u_std)
        ctx.pred_shape, ctx.pred_dtype = pred.shape, pred.dtype
        return loss

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        seed, u_std = ctx.saved_tensors
        grad = ctx.backward_fn(seed, u_std, g.contiguous(), dtype=ctx.pred_dtype)
        return grad.reshape(ctx.pred_shape), None, None, None, None, None, None


def pde_residual_loss(pred_norm: torch.Tensor, theta_fine: torch.Tensor, f_fine: torch.Tensor,
                      stats: NormStats, use_kernel: bool | None = None) -> torch.Tensor:
    """Mean squared normalized PDE residual of a normalized NCHW prediction.

    Args:
        pred_norm: model output ``(B, 1, H, W)`` in normalized space.
        theta_fine / f_fine: physical-scale coefficient and forcing ``(B, H, W)``.
        stats: normalization statistics, 0-d or ``(B, 1, 1)``.
        use_kernel: ``None`` or ``True`` runs the fused K1 kernels (their
            plain twins for CPU tensors), ``False`` the plain twins on any
            device. Without a gradient to take (``torch.no_grad()``, or a
            ``pred_norm`` that needs none) the forward writes no seed.
    """
    data = {"theta": theta_fine, "f": f_fine, "u_mean": stats.u_mean, "u_std": stats.u_std,
            "f_std": stats.f_std}
    for name, t in data.items():
        if t.requires_grad:
            raise ValueError(f"pde_residual_loss: {name} is data and takes no gradient")
    with span("physics.loss"):
        args = tuple(t.contiguous() for t in data.values())
        kernel = use_kernel is not False
        if torch.is_grad_enabled() and pred_norm.requires_grad:
            return _PdeResidualLoss.apply(pred_norm, *args, kernel)
        forward = kernel_pde_loss_forward if kernel else plain_pde_residual_loss
        return forward(pred_norm.contiguous(), *args, seed=False)[0]
