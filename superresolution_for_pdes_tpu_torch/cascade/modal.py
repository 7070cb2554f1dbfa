"""Per-level modal correction in the DST-I eigenbasis, and its calibration
(port of ``cascade/modal.py``).

A gain array in ``amp_levels`` is self-describing: 0-d is a scalar amplitude,
1-d (length ``12 * bands_per_octave``) radial bands over ``log2 sqrt(i^2 +
j^2)``, 2-d a separable log-grid over the (i, j) octaves. The correction is
``dst2(dst2(field) * g)``; the transforms are fp32 matmuls (TF32 off).

:func:`calibrate_modal` fits one gain per band and level, by least squares of
truth onto prediction, on scenes it generates itself from a seed (the
training k-range and the exact solver; never the scenes it will be evaluated
on), level by level in the corrected regime each level deploys in. The band
sums are deterministic, so the same bundle calibrates to the same bits: the
grid kind is the separable product ``B^T num B`` with a one-hot ``B``, the
radial kind a sum over each band's modes in a fixed order (the JAX package's
``.at[b].add`` would become a scatter-add, whose float atomics on CUDA add in
no fixed order).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
from superresolution_for_pdes_tpu_torch.solver.dst import sine_basis
from superresolution_for_pdes_tpu_torch.utils.profiling import span

N_OCTAVES = 12


@functools.lru_cache(maxsize=None)
def radial_band_index(n: int, bands_per_octave: int) -> np.ndarray:
    """(n, n) int map: DST mode (i, j) -> logarithmic radial band."""
    i = np.arange(1, n + 1)
    kr = np.sqrt(i[:, None] ** 2 + i[None, :] ** 2)
    nb = N_OCTAVES * bands_per_octave
    return np.clip((bands_per_octave * np.log2(kr)).astype(np.int32), 0, nb - 1)


@functools.lru_cache(maxsize=None)
def axis_band_index(n: int, bands_per_octave: int) -> np.ndarray:
    """(n,) int map: 1-D mode index -> logarithmic octave band."""
    i = np.arange(1, n + 1)
    nb = N_OCTAVES * bands_per_octave
    return np.clip((bands_per_octave * np.log2(i)).astype(np.int32), 0, nb - 1)


def dst2(x: torch.Tensor) -> torch.Tensor:
    """Orthogonal 2-D DST-I on the last two axes (its own inverse)."""
    S = sine_basis(x.shape[-1], x.dtype, x.device)
    return torch.matmul(torch.matmul(S, x), S)


@functools.lru_cache(maxsize=None)
def _radial_segments(n: int, bands_per_octave: int) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """The flattened modes ordered by radial band (stable), and each band's
    mode count (empty bands included)."""
    band = radial_band_index(n, bands_per_octave).ravel()
    order = np.argsort(band, kind="stable")
    counts = np.bincount(band, minlength=N_OCTAVES * bands_per_octave)
    return order, tuple(int(c) for c in counts)


@functools.lru_cache(maxsize=None)
def _index_on(index, n: int, bands_per_octave: int, device) -> torch.Tensor:
    """A band index (:func:`radial_band_index` or :func:`axis_band_index`) as
    a long tensor on ``device``, copied there once."""
    return torch.as_tensor(index(n, bands_per_octave), dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def _axis_one_hot(n: int, bands_per_octave: int, dtype, device) -> torch.Tensor:
    """(n, 12 * bpo) one-hot map of each 1-D mode to its octave band."""
    nb = N_OCTAVES * bands_per_octave
    B = np.zeros((n, nb))
    B[np.arange(n), axis_band_index(n, bands_per_octave)] = 1.0
    return torch.as_tensor(B, dtype=dtype, device=device)


def _band_sums(x: torch.Tensor, bands_per_octave: int, kind: str) -> torch.Tensor:
    """Sums of an (n, n) modal field over each radial or grid band, in a
    fixed order."""
    n = x.shape[-1]
    if kind == "radial":
        order, counts = _radial_segments(n, bands_per_octave)
        flat = x.reshape(-1)[torch.as_tensor(order, device=x.device)]
        return torch.stack([seg.sum() for seg in torch.split(flat, counts)])
    B = _axis_one_hot(n, bands_per_octave, x.dtype, x.device)
    return torch.matmul(torch.matmul(B.T, x), B)


def band_gains(pred: torch.Tensor, truth: torch.Tensor, bands_per_octave: int = 4,
               kind: str = "radial") -> torch.Tensor:
    """Least-squares per-band gains fitting truth onto pred over a scene batch:
    ``g_b = sum_{m in b} <T_m, P_m> / sum_{m in b} <P_m, P_m>`` in the DST
    basis. A ``(12 * bpo,)`` vector for ``kind="radial"``, a
    ``(12 * bpo, 12 * bpo)`` matrix for ``kind="grid"``; a band with no modes
    or no prediction energy gets gain 0."""
    if kind not in ("radial", "grid"):
        raise ValueError(f"unknown band kind: {kind!r}")
    P, T = dst2(pred), dst2(truth)
    lead = tuple(range(P.ndim - 2))
    num_f = torch.sum(P * T, dim=lead) if lead else P * T
    den_f = torch.sum(P * P, dim=lead) if lead else P * P
    num = _band_sums(num_f, bands_per_octave, kind)
    den = _band_sums(den_f, bands_per_octave, kind)
    return num / torch.clamp(den, min=1e-30)


def apply_level_correction(field: torch.Tensor, gains) -> torch.Tensor:
    """Apply a scalar (0-d), radial (1-d) or log-grid (2-d) correction. The
    band index of a shape is copied to the device once and kept there: a copy
    from pageable host memory on every call would wait for the stream."""
    with span("cascade.modal"):
        gains = torch.as_tensor(gains, device=field.device)
        if gains.ndim == 0:
            return field * gains
        n = field.shape[-1]
        bpo = gains.shape[0] // N_OCTAVES
        if gains.ndim == 1:
            g = gains[_index_on(radial_band_index, n, bpo, field.device)]
        else:
            bi = _index_on(axis_band_index, n, bpo, field.device)
            g = gains[bi[:, None], bi[None, :]]
        return dst2(dst2(field) * g.to(field.dtype))


def fit_modal_gains(model, variables, scenes: Dict, target_resolution: int = 640,
                    stats_mode: str = "tile", train_stats: Optional[NormStats] = None,
                    start_resolution: int = 40, coarse_tile=20, overlap=False,
                    symmetrize: bool = False, bands_per_octave: int = 4,
                    kind: str = "radial",
                    scene_chunk: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """The scene-consuming part of :func:`calibrate_modal`: per-level band
    gains fit on ``scenes`` (``{u, f, theta}`` by resolution, with a leading
    scene axis), each level run on the previous level's corrected field.
    ``scene_chunk`` is the cascade's scenes per model call; each level's gains
    are fit on all scenes at once."""
    from superresolution_for_pdes_tpu_torch.cascade.upscale import (
        check_cascade_args,
        level_program,
        level_resolutions,
    )

    check_cascade_args(model, variables, stats_mode, train_stats)
    gains = []
    current = scenes["u"][start_resolution]
    for i, res in enumerate(level_resolutions(start_resolution, target_resolution)):
        pred = level_program(model, variables, i, current, scenes, res, stats_mode,
                             train_stats, coarse_tile, overlap, symmetrize,
                             scene_chunk=scene_chunk)
        g = band_gains(pred, scenes["u"][res], bands_per_octave, kind)
        gains.append(g)
        current = apply_level_correction(pred, g)
    return tuple(gains)


def calibrate_modal(model, variables, seed_or_generator, n_scenes: int = 32,
                    target_resolution: int = 640, k_range=(6.0, 12.0),
                    stats_mode: str = "tile", train_stats: Optional[NormStats] = None,
                    start_resolution: int = 40, coarse_tile=20, overlap=False,
                    symmetrize: bool = False, bands_per_octave: int = 4,
                    kind: str = "radial", theta_range=(0.5, 2.0),
                    device=None, scene_chunk: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Per-level modal gains from ``n_scenes`` scenes drawn from an int seed
    or a ``torch.Generator`` (k ~ U(``k_range``), theta ~ U(``theta_range``))
    and solved exactly on ``device`` (default ``cuda``; raises without a
    card). Pass the result as ``amp_levels=`` to the cascade. The weights
    must be on ``device``; ``scene_chunk`` as for :func:`fit_modal_gains`."""
    from superresolution_for_pdes_tpu_torch.cascade.multires import (
        solve_multi_resolution_batch,
    )
    from superresolution_for_pdes_tpu_torch.cascade.upscale import level_resolutions

    scenes = solve_multi_resolution_batch(
        seed_or_generator, n_scenes, n_coarse=start_resolution,
        resolutions=level_resolutions(start_resolution, target_resolution),
        k_range=tuple(k_range), theta_range=tuple(theta_range), device=device)
    return fit_modal_gains(model, variables, scenes, target_resolution, stats_mode,
                           train_stats, start_resolution, coarse_tile, overlap, symmetrize,
                           bands_per_octave, kind, scene_chunk)
