"""Normalization statistics and model-input assembly (port of
``data/normalization.py``).

* ``std`` is the unbiased estimator (``ddof=1``);
* theta counts as constant when its std is below 1e-6, and then its
  ``(mean, std)`` is pinned to ``(0, 1)`` so the channel passes through;
* ``u_coarse`` is normalized with the u statistics and upsampled to the fine
  grid with align-corners bilinear interpolation;
* the model input is **NCHW** (the JAX package's is NHWC), channels
  ``[u_up, theta, f]`` plus, with ``scale_channels``, ``log(u_std + 1e-30)/10``
  and ``log(f_std + 1e-30)/10``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import torch

from superresolution_for_pdes_tpu_torch.ops.resize import resize_align_corners

THETA_CONSTANT_TOL = 1e-6
_STD_FLOOR = 1e-20
_LOG_EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class NormStats:
    """Normalization statistics. Fields are 0-d tensors for split-level stats
    or keep-dim tensors (e.g. ``(T, 1, 1)``) for per-sample/per-tile stats;
    all downstream math broadcasts over either."""

    u_mean: torch.Tensor
    u_std: torch.Tensor
    f_mean: torch.Tensor
    f_std: torch.Tensor
    theta_mean: torch.Tensor
    theta_std: torch.Tensor
    theta_is_constant: torch.Tensor

    def normalize_u(self, u: torch.Tensor) -> torch.Tensor:
        return (u - self.u_mean) / self.u_std

    def denormalize_u(self, u_norm: torch.Tensor) -> torch.Tensor:
        return u_norm * self.u_std + self.u_mean

    def normalize_f(self, f: torch.Tensor) -> torch.Tensor:
        return (f - self.f_mean) / self.f_std

    def normalize_theta(self, theta: torch.Tensor) -> torch.Tensor:
        """No-op when theta is constant: (mean, std) are (0, 1) then."""
        return (theta - self.theta_mean) / self.theta_std

    @classmethod
    def from_fields(cls, u: torch.Tensor, f: torch.Tensor, theta: torch.Tensor,
                    dims: Optional[Sequence[int]] = None) -> "NormStats":
        """Stats over ``dims`` (default: every axis, giving 0-d stats, the JAX
        semantics); with ``dims`` the reduced axes are kept as size 1."""
        keep = dims is not None

        def mean(x):
            return x.mean(dim=dims, keepdim=keep)

        def std(x):
            return x.std(dim=dims, correction=1, keepdim=keep)

        theta_std = std(theta)
        is_const = theta_std < THETA_CONSTANT_TOL
        zero, one = torch.zeros_like(theta_std), torch.ones_like(theta_std)
        return cls(
            u_mean=mean(u), u_std=std(u), f_mean=mean(f), f_std=std(f),
            theta_mean=torch.where(is_const, zero, mean(theta)),
            theta_std=torch.where(is_const, one, theta_std),
            theta_is_constant=is_const,
        )

    @classmethod
    def from_dataset(cls, dataset: Mapping[str, torch.Tensor]) -> "NormStats":
        """Split-level stats of a dataset dict (u from ``u_fine``)."""
        return cls.from_fields(dataset["u_fine"], dataset["f_fine"], dataset["theta_fine"])


def per_sample_stats(u_coarse: torch.Tensor, f_fine: torch.Tensor,
                     theta_fine: torch.Tensor) -> NormStats:
    """Self-normalization stats from each sample's own known fields, reduced
    over the last two axes (kept as size 1); std floored at 1e-20."""

    def ms(x):
        mean = x.mean(dim=(-2, -1), keepdim=True)
        std = x.std(dim=(-2, -1), correction=1, keepdim=True)
        return mean, torch.clamp(std, min=_STD_FLOOR)

    u_mean, u_std = ms(u_coarse)
    f_mean, f_std = ms(f_fine)
    t_mean, t_std = ms(theta_fine)
    is_const = theta_fine.std(dim=(-2, -1), correction=1, keepdim=True) < THETA_CONSTANT_TOL
    return NormStats(
        u_mean=u_mean, u_std=u_std, f_mean=f_mean, f_std=f_std,
        theta_mean=torch.where(is_const, torch.zeros_like(t_mean), t_mean),
        theta_std=torch.where(is_const, torch.ones_like(t_std), t_std),
        theta_is_constant=is_const,
    )


def make_model_inputs(u_coarse: torch.Tensor, f_fine: torch.Tensor, theta_fine: torch.Tensor,
                      stats: NormStats, fine_shape: Optional[Tuple[int, int]] = None,
                      scale_channels: bool = False) -> torch.Tensor:
    """NCHW model input ``(..., C, H, W)`` with channels
    ``[u_up, theta, f(, log_u, log_f)]``."""
    if fine_shape is None:
        fine_shape = (f_fine.shape[-2], f_fine.shape[-1])
    u_up = resize_align_corners(stats.normalize_u(u_coarse), tuple(fine_shape), "bilinear")
    channels = [u_up, stats.normalize_theta(theta_fine), stats.normalize_f(f_fine)]
    if scale_channels:
        log_u = torch.log(stats.u_std + _LOG_EPS) / 10.0
        log_f = torch.log(stats.f_std + _LOG_EPS) / 10.0
        channels.append(torch.broadcast_to(log_u, f_fine.shape).to(f_fine.dtype))
        channels.append(torch.broadcast_to(log_f, f_fine.shape).to(f_fine.dtype))
    return torch.stack(channels, dim=-3)


def make_targets(u_fine: torch.Tensor, stats: NormStats) -> torch.Tensor:
    """Normalized single-channel NCHW target ``(..., 1, H, W)``."""
    return stats.normalize_u(u_fine).unsqueeze(-3)
