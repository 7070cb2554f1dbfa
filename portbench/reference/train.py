"""Plain-PyTorch training step, written from the recipe: the model input and
target normalised per sample (statistics of the coarse u, the fine f and the
fine theta) or with the statistics of the whole set, the loss
``mean((pred - y)^2) + w * mean(((theta * L(pred * u_std + u_mean) - f) / f_std)^2)``
with the truncated 5-point ``L`` (``h = 1/(n-1)``), its gradient by autograd,
clipping by the global norm (scale by ``max_norm / norm`` once ``norm >=
max_norm``) and AdamW (decoupled weight decay on every parameter).

Departures from the program: ``L`` is a ``F.conv2d`` (the program runs the
fused kernel K1 forward and backward); AdamW is written out here rather
than taken from ``torch.optim``; the model's running BatchNorm statistics are
not kept. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from portbench.reference.cascade import LOG_EPS, STD_FLOOR, THETA_CONSTANT_TOL

Arrays = Dict[str, torch.Tensor]
# a model family's forward in training mode: (tensors, input) -> prediction
Model = Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]


def dataset_stats(raw: Arrays) -> Dict[str, torch.Tensor]:
    """0-d statistics of a whole set, taken in float64: u from ``u_fine``,
    f from ``f_fine``, theta from ``theta_fine`` (pinned to (0, 1) when
    constant)."""
    out = {}
    for key, field in (("u", "u_fine"), ("f", "f_fine"), ("theta", "theta_fine")):
        x = raw[field].double()
        out[f"{key}_mean"], out[f"{key}_std"] = x.mean(), x.std(correction=1)
    if out["theta_std"] < THETA_CONSTANT_TOL:
        out["theta_mean"], out["theta_std"] = out["theta_mean"] * 0, out["theta_std"] * 0 + 1
    return {k: v.float() for k, v in out.items()}


def per_sample_stats(raw: Arrays) -> Dict[str, torch.Tensor]:
    """``(B, 1, 1)`` statistics of each sample's coarse u, fine f and fine
    theta (unbiased std floored at 1e-20; theta pinned to (0, 1) where constant)."""
    out = {}
    for key, field in (("u", "u_coarse"), ("f", "f_fine"), ("theta", "theta_fine")):
        x = raw[field]
        std = x.std(dim=(-2, -1), correction=1, keepdim=True)
        out[f"{key}_mean"] = x.mean(dim=(-2, -1), keepdim=True)
        out[f"{key}_std"] = std.clamp(min=STD_FLOOR)
        if key == "theta":
            const = std < THETA_CONSTANT_TOL
            out["theta_mean"] = torch.where(const, 0.0, out["theta_mean"])
            out["theta_std"] = torch.where(const, 1.0, out["theta_std"])
    return out


def batch_arrays(raw: Arrays, rows: torch.Tensor, recipe: Dict,
                 set_stats: Dict[str, torch.Tensor] | None = None) -> Arrays:
    """The rows' model input ``x``, target ``y`` and the physics term's data,
    normalised as the recipe says."""
    sub = {k: v[rows] for k, v in raw.items()}
    st = per_sample_stats(sub) if recipe["normalization"] == "per_sample" else set_stats
    fine = sub["f_fine"].shape[-1]
    u_n = ((sub["u_coarse"] - st["u_mean"]) / st["u_std"])[:, None]
    chans = [F.interpolate(u_n, size=(fine, fine), mode="bilinear", align_corners=True)[:, 0],
             (sub["theta_fine"] - st["theta_mean"]) / st["theta_std"],
             (sub["f_fine"] - st["f_mean"]) / st["f_std"]]
    if recipe["scale_channels"]:
        for key in ("u_std", "f_std"):
            chans.append(torch.broadcast_to(torch.log(st[key] + LOG_EPS) / 10.0,
                                            sub["f_fine"].shape))
    return {"x": torch.stack(chans, dim=1),
            "y": ((sub["u_fine"] - st["u_mean"]) / st["u_std"])[:, None],
            "theta": sub["theta_fine"], "f": sub["f_fine"],
            "u_mean": st["u_mean"], "u_std": st["u_std"], "f_std": st["f_std"]}


def laplacian(u: torch.Tensor) -> torch.Tensor:
    """Truncated 5-point ``L u`` of ``(B, 1, n, n)`` with zeros outside."""
    n = u.shape[-1]
    w = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]],
                     dtype=u.dtype, device=u.device) * (n - 1) ** 2
    return F.conv2d(u, w.reshape(1, 1, 3, 3), padding=1)


def _slab(stat: torch.Tensor) -> torch.Tensor:
    """A statistic shaped to broadcast over ``(B, 1, n, n)``: 0-d as it is,
    ``(B, 1, 1)`` with a channel axis."""
    return stat[:, None] if stat.ndim else stat


def loss(model: Model, params: Dict[str, torch.Tensor], batch: Arrays,
         physics_weight: float) -> torch.Tensor:
    pred = model(params, batch["x"])
    total = torch.mean((pred - batch["y"]) ** 2)
    if physics_weight > 0.0:
        u = pred * _slab(batch["u_std"]) + _slab(batch["u_mean"])
        r = (batch["theta"][:, None] * laplacian(u) - batch["f"][:, None]) / _slab(batch["f_std"])
        total = total + physics_weight * torch.mean(r ** 2)
    return total


class AdamW:
    """``torch.optim.AdamW``'s update, written out: ``p *= 1 - lr wd``; ``m``,
    ``v`` moving averages; ``p -= lr / (1 - b1^t) * m / (sqrt(v / (1 - b2^t)) + eps)``."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps, self.t = lr, weight_decay, betas, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                p.mul_(1 - self.lr * self.wd)
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k] / c2).sqrt().add_(self.eps)
                p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def step(model: Model, params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
         opt: AdamW, batch: Arrays, physics_weight: float, grad_clip: float):
    """One step of the trainable ``params`` of ``model`` in place (``buffers``:
    the rest of the model's tensors): ``(loss, clipped gradients)``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    value = loss(model, {**leaves, **buffers}, batch, physics_weight)
    grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    scale = 1.0 if float(norm) < grad_clip else grad_clip / float(norm)
    grads = {k: g * scale for k, g in grads.items()}
    opt.step(params, grads)
    return float(value.detach()), grads
