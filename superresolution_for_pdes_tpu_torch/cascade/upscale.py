"""Multi-level ML upscaling 40 -> 80 -> 160 -> 320 -> 640 (port of
``cascade/upscale.py``).

Per level: normalization stats (four modes), tiling of the current field and
of the next level's f/theta, model input assembly, ONE batched model call over
all tiles (all scenes too), denormalization, stitching, optional physics
refinement (``refine_cycles`` Galerkin V-cycles of the known PDE, whose finest
level runs the stencil kernels K2/K3 on CUDA), and the optional per-level
modal correction -- in that order.

``model`` is an ``nn.Module`` that fixes the architecture; ``variables`` is
its weights: ``None`` (the module's own), a state_dict, a module of the same
architecture, or a sequence of those with one entry per level (level ``i``
uses entry ``min(i, len - 1)``). The model runs in eval mode under
``torch.no_grad()``.

A leading scene axis on the data fields is a batch dimension written out:
every scene's tiles go through the same model call. Eval-mode BatchNorm is
per sample, so this equals the JAX package's ``lax.map`` over scenes.

:func:`ml_cascade` runs :func:`level_program` once per level;
:func:`ml_cascade_stepwise` runs the same calls and synchronises after each,
so each level's wall time is observable (the statistical harness's timings);
:func:`calibrate_amplitude` fits one amplitude per level on self-generated
scenes (the modal gains are :func:`~.modal.calibrate_modal`'s).
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from superresolution_for_pdes_tpu_torch.cascade.modal import apply_level_correction
from superresolution_for_pdes_tpu_torch.cascade.tiles import (
    split_tiles,
    split_tiles_overlapping,
    stitch_tiles,
    stitch_tiles_overlapping,
)
from superresolution_for_pdes_tpu_torch.data.normalization import (
    NormStats,
    make_model_inputs,
    per_sample_stats,
)
from superresolution_for_pdes_tpu_torch.ops.resize import resize_align_corners
from superresolution_for_pdes_tpu_torch.solver.multigrid import vcycle

STATS_MODES = ("oracle", "scene", "train", "tile")


def _apply(model: nn.Module, weights, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode forward of ``model``'s architecture with ``weights``."""
    if weights is None:
        return model(x)
    if isinstance(weights, nn.Module):
        return weights(x)
    return functional_call(model, dict(weights), (x,))


def _model_forward(model, weights, x: torch.Tensor) -> torch.Tensor:
    """Model call on ``(..., C, H, W)`` inputs, flattened to one batch."""
    lead = x.shape[:-3]
    out = _apply(model, weights, x.reshape((-1,) + x.shape[-3:]))
    return out.reshape(lead + out.shape[-3:])


def _dihedral_apply(model, weights, x: torch.Tensor) -> torch.Tensor:
    """Average the model over the 8 symmetries of the square (test-time
    ensembling), as one model call over an 8x larger batch. ``x`` is NCHW."""
    xs = []
    for flip in (False, True):
        xf = torch.flip(x, dims=(-2,)) if flip else x
        for k in range(4):
            xs.append(torch.rot90(xf, k, dims=(-2, -1)))
    preds = torch.chunk(_apply(model, weights, torch.cat(xs, dim=0)), 8, dim=0)
    out = []
    for i, flip in enumerate((False, True)):
        for k in range(4):
            p = torch.rot90(preds[4 * i + k], -k, dims=(-2, -1))
            out.append(torch.flip(p, dims=(-2,)) if flip else p)
    return sum(out) / len(out)


def _refine(u: torch.Tensor, f: torch.Tensor, theta: torch.Tensor, cycles: int,
            use_kernels: bool | None = None) -> torch.Tensor:
    """``cycles`` Galerkin V-cycles of ``diag(theta) L u = f`` starting from the
    ML prediction (honest: only the level's inputs f and theta are used)."""
    b = -(f / theta)
    for _ in range(cycles):
        u = vcycle(u, b, use_kernels=use_kernels)
    return u


def _level_overlap(overlap, i: int) -> bool:
    """One bool for every level, or one per level (trailing levels reuse the
    last)."""
    if isinstance(overlap, (list, tuple)):
        return bool(overlap[min(i, len(overlap) - 1)])
    return bool(overlap)


def _level_tile(coarse_tile, i: int) -> int:
    """One coarse tile size for every level, or one per level (trailing levels
    reuse the last)."""
    if isinstance(coarse_tile, (list, tuple)):
        return int(coarse_tile[min(i, len(coarse_tile) - 1)])
    return int(coarse_tile)


def _level_weights(variables, i: int):
    if isinstance(variables, (list, tuple)):
        return variables[min(i, len(variables) - 1)]
    return variables


def _level_body(model, weights, current: torch.Tensor, f_next: torch.Tensor,
                theta_next: torch.Tensor, stats_source, coarse_tile: int, overlap: bool,
                stats_kind: str, symmetrize: bool = False, refine_cycles: int = 0,
                use_kernels: bool | None = None) -> torch.Tensor:
    """One cascade level on ``(..., r, r)`` fields (optional leading scene
    axis)."""
    fine_tile = 2 * coarse_tile
    next_res = f_next.shape[-1]
    if stats_kind == "per_tile":
        stats = None
    elif stats_kind == "precomputed":
        stats = stats_source
    else:  # "field": per-scene stats, shaped to broadcast over the tile axis
        stats = NormStats.from_fields(stats_source.unsqueeze(-3), f_next.unsqueeze(-3),
                                      theta_next.unsqueeze(-3), dims=(-2, -1))

    def run_tiles(u_tiles, f_tiles, theta_tiles):
        st = per_sample_stats(u_tiles, f_tiles, theta_tiles) if stats is None else stats
        x = make_model_inputs(u_tiles, f_tiles, theta_tiles, st,
                              fine_shape=(fine_tile, fine_tile),
                              scale_channels=model.in_channels > 3)
        if symmetrize:
            lead = x.shape[:-3]
            pred = _dihedral_apply(model, weights, x.reshape((-1,) + x.shape[-3:]))
            pred = pred.reshape(lead + pred.shape[-3:])
        else:
            pred = _model_forward(model, weights, x)
        return st.denormalize_u(pred[..., 0, :, :])

    if overlap:
        c_stride = coarse_tile // 2
        up_tiles = run_tiles(
            split_tiles_overlapping(current, coarse_tile, c_stride),
            split_tiles_overlapping(f_next, fine_tile, 2 * c_stride),
            split_tiles_overlapping(theta_next, fine_tile, 2 * c_stride),
        )
        out = stitch_tiles_overlapping(up_tiles, next_res, 2 * c_stride)
    else:
        up_tiles = run_tiles(split_tiles(current, coarse_tile),
                             split_tiles(f_next, fine_tile),
                             split_tiles(theta_next, fine_tile))
        out = stitch_tiles(up_tiles)
    if refine_cycles > 0:
        out = _refine(out, f_next, theta_next, refine_cycles, use_kernels)
    return out


def level_resolutions(start: int, target: int) -> tuple[int, ...]:
    """The resolutions the cascade reaches from ``start`` to ``target``, doubling."""
    res, out = start, []
    while res < target:
        res *= 2
        out.append(res)
    return tuple(out)


def check_cascade_args(model: nn.Module, variables, stats_mode: str,
                       train_stats: Optional[NormStats]) -> None:
    """Validate a cascade's stats mode and weights, and put the model in eval
    mode (the entry points' shared preamble)."""
    if stats_mode not in STATS_MODES:
        raise ValueError(f"unknown stats_mode: {stats_mode!r}")
    if stats_mode == "train" and train_stats is None:
        raise ValueError("stats_mode='train' requires train_stats")
    model.eval()
    for w in (variables if isinstance(variables, (list, tuple)) else [variables]):
        if isinstance(w, nn.Module):
            w.eval()
        elif w is not None and not isinstance(w, Mapping):
            raise TypeError(f"variables entries must be state_dicts or modules, got {type(w)}")


def level_program(model: nn.Module, variables, i: int, current: torch.Tensor, data: Dict,
                  res: int, stats_mode: str = "scene", train_stats: Optional[NormStats] = None,
                  coarse_tile=20, overlap=False, symmetrize: bool = False,
                  refine_cycles: int = 0, amp=None,
                  use_kernels: bool | None = None) -> torch.Tensor:
    """Level ``i`` of the cascade, to ``res``, on ``current`` (one field or a
    scene batch) with ``data``'s f and theta at ``res`` (and its u, for the
    oracle stats), then the level's correction ``amp`` if given. Runs under
    ``torch.no_grad()``; :func:`check_cascade_args` comes first."""
    if stats_mode == "oracle":
        source, kind = data["u"][res], "field"
    elif stats_mode == "scene":
        source, kind = current, "field"
    elif stats_mode == "train":
        source, kind = train_stats, "precomputed"
    else:
        source, kind = None, "per_tile"
    with torch.no_grad():
        out = _level_body(
            model, _level_weights(variables, i), current, data["f"][res], data["theta"][res],
            source, _level_tile(coarse_tile, i), _level_overlap(overlap, i), kind, symmetrize,
            refine_cycles, use_kernels)
        return out if amp is None else apply_level_correction(out, amp)


def _sync(t: torch.Tensor) -> None:
    """Wait for the device work that produced ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def ml_cascade_stepwise(
    model: nn.Module,
    variables,
    data: Dict,
    target_resolution: int,
    stats_mode: str = "scene",
    train_stats: Optional[NormStats] = None,
    start_resolution: int = 40,
    coarse_tile=20,
    overlap=False,
    symmetrize: bool = False,
    refine_cycles: int = 0,
    amp_levels=None,
    use_kernels: bool | None = None,
) -> Tuple[Dict[int, torch.Tensor], Dict[int, float]]:
    """The cascade one level at a time, returning ``(fields by resolution,
    wall seconds by resolution)``: each level ends in a device synchronisation,
    so the cumulative sum of the level times is the time to reach each
    resolution from one pass. The fields are :func:`ml_cascade`'s, bit for
    bit (arguments as there)."""
    check_cascade_args(model, variables, stats_mode, train_stats)
    current = data["u"][start_resolution]
    outs: Dict[int, torch.Tensor] = {}
    times: Dict[int, float] = {}
    for i, res in enumerate(level_resolutions(start_resolution, target_resolution)):
        t0 = time.perf_counter()
        current = level_program(
            model, variables, i, current, data, res, stats_mode, train_stats, coarse_tile,
            overlap, symmetrize, refine_cycles,
            None if amp_levels is None else amp_levels[i], use_kernels)
        _sync(current)
        times[res] = time.perf_counter() - t0
        outs[res] = current
    return outs, times


def warmup_cascade_stepwise(model: nn.Module, variables, data: Dict, target_resolution: int,
                            start_resolution: int = 40, **kwargs) -> None:
    """Warm what a timed :func:`ml_cascade_stepwise` pass on ``data`` will
    run, so that the pass measures execution (arguments as there).

    The JAX package compiles each level's program here without running it.
    PyTorch compiles nothing ahead, so this builds the stencil library where
    the refine path will launch it on a card, and runs every level once on
    the first scene of ``data`` only (the caching allocator and cuDNN's plans
    warm): it costs 1/N of an N-scene pass of device work, where the JAX
    package's warmup costs none.
    """
    first = {key: {r: (v[:1] if v.ndim == 3 else v) for r, v in data[key].items()}
             for key in ("u", "f", "theta")}
    if kwargs.get("refine_cycles", 0) > 0 and first["u"][start_resolution].is_cuda:
        from superresolution_for_pdes_tpu_torch.ops.stencil_kernels import load_kernels

        load_kernels()
    fields, _ = ml_cascade_stepwise(model, variables, first, target_resolution,
                                    start_resolution=start_resolution, **kwargs)
    _sync(fields[max(fields)])


def ml_cascade(
    model: nn.Module,
    variables,
    data: Dict,
    target_resolution: int,
    stats_mode: str = "scene",
    train_stats: Optional[NormStats] = None,
    start_resolution: int = 40,
    coarse_tile=20,
    overlap=False,
    symmetrize: bool = False,
    refine_cycles: int = 0,
    amp_levels=None,
    use_kernels: bool | None = None,
) -> Dict[int, torch.Tensor]:
    """The cascade from ``start_resolution`` to ``target_resolution``,
    returning the ML field at every intermediate resolution.

    ``data`` is ``{u: {r0}, f: {res}, theta: {res}}`` (plus ``u`` at every
    level for ``stats_mode="oracle"``), with fields ``(r, r)`` or
    ``(B, r, r)``. ``stats_mode``: ``"oracle"`` (stats from the true fine
    solution), ``"scene"`` (from the current field), ``"train"``
    (``train_stats``), ``"tile"`` (per-tile self-normalization).
    ``amp_levels`` is one gain array per level (see
    :func:`~superresolution_for_pdes_tpu_torch.cascade.modal.apply_level_correction`).
    ``use_kernels`` is passed to the refinement's V-cycles.
    """
    check_cascade_args(model, variables, stats_mode, train_stats)
    current = data["u"][start_resolution]
    outs: Dict[int, torch.Tensor] = {}
    for i, res in enumerate(level_resolutions(start_resolution, target_resolution)):
        current = level_program(
            model, variables, i, current, data, res, stats_mode, train_stats, coarse_tile,
            overlap, symmetrize, refine_cycles,
            None if amp_levels is None else amp_levels[i], use_kernels)
        outs[res] = current
    return outs


def ml_multi_level_upscale(model, variables, data: Dict, target_resolution: int,
                           stats_mode: str = "oracle", **kwargs) -> torch.Tensor:
    """The cascade's field at ``target_resolution`` (keyword arguments as for
    :func:`ml_cascade`)."""
    return ml_cascade(model, variables, data, target_resolution, stats_mode=stats_mode,
                      **kwargs)[target_resolution]


def interpolation_upscale(u: torch.Tensor, target_resolution: int,
                          method: str = "bilinear") -> torch.Tensor:
    """Direct align-corners interpolation baseline."""
    return resize_align_corners(u, (target_resolution, target_resolution), method)


def multi_level_interpolation_upscale(u: torch.Tensor, target_resolution: int,
                                      method: str = "bilinear") -> torch.Tensor:
    """2x-stepped interpolation baseline."""
    res = u.shape[-1]
    while res < target_resolution:
        res *= 2
        u = resize_align_corners(u, (res, res), method)
    return u


def fit_amplitudes(model: nn.Module, variables, scenes: Dict, target_resolution: int = 640,
                   stats_mode: str = "tile", train_stats: Optional[NormStats] = None,
                   start_resolution: int = 40, coarse_tile=20, overlap=False,
                   symmetrize: bool = False) -> torch.Tensor:
    """The scene-consuming part of :func:`calibrate_amplitude`: one amplitude
    per level, ``mean over scenes of std(truth) / std(pred)`` with the
    population std (``correction=0``), each level run on the previous level's
    corrected field."""
    check_cascade_args(model, variables, stats_mode, train_stats)
    current = scenes["u"][start_resolution]
    amps = []
    for i, res in enumerate(level_resolutions(start_resolution, target_resolution)):
        pred = level_program(model, variables, i, current, scenes, res, stats_mode,
                             train_stats, coarse_tile, overlap, symmetrize)
        truth_std = torch.std(scenes["u"][res], dim=(-2, -1), correction=0)
        pred_std = torch.std(pred, dim=(-2, -1), correction=0)
        amp = torch.mean(truth_std / torch.clamp(pred_std, min=1e-30))
        amps.append(amp)
        current = pred * amp
    return torch.stack(amps)


def calibrate_amplitude(model: nn.Module, variables, seed_or_generator, n_scenes: int = 8,
                        target_resolution: int = 640, k_range=(6.0, 12.0),
                        stats_mode: str = "tile", train_stats: Optional[NormStats] = None,
                        start_resolution: int = 40, coarse_tile=20, overlap=False,
                        symmetrize: bool = False, theta_range=(0.5, 2.0),
                        device=None) -> torch.Tensor:
    """One amplitude per level from ``n_scenes`` scenes drawn from an int seed
    or a ``torch.Generator`` (the training k-range and the exact solver; never
    the scenes the cascade is evaluated on), solved on ``device`` (default
    ``cuda``; raises without a card). Pass the result as ``amp_levels=`` to
    the cascade. The weights must be on ``device``."""
    from superresolution_for_pdes_tpu_torch.cascade.multires import (
        solve_multi_resolution_batch,
    )

    scenes = solve_multi_resolution_batch(
        seed_or_generator, n_scenes, n_coarse=start_resolution,
        resolutions=level_resolutions(start_resolution, target_resolution),
        k_range=tuple(k_range), theta_range=tuple(theta_range), device=device)
    return fit_amplitudes(model, variables, scenes, target_resolution, stats_mode, train_stats,
                          start_resolution, coarse_tile, overlap, symmetrize)
