"""Multi-level ML upscaling 40 -> 80 -> 160 -> 320 -> 640 (port of
``cascade/upscale.py``).

Per level: normalization stats (four modes), tiling of the current field and
of the next level's f/theta, model input assembly, one batched model call over
the tiles of a chunk of scenes, denormalization, stitching, optional physics
refinement (``refine_cycles`` Galerkin V-cycles of the known PDE, whose finest
level runs the stencil kernels K2/K3 on CUDA), and the optional per-level
modal correction -- in that order.

``model`` is an ``nn.Module`` that fixes the architecture; ``variables`` is
its weights: ``None`` (the module's own), a state_dict, a module of the same
architecture, or a sequence of those with one entry per level (level ``i``
uses entry ``min(i, len - 1)``). The model runs in eval mode under
``torch.no_grad()``.

A leading scene axis on the data fields is a batch dimension written out.
Each level splits it into chunks of ``scene_chunk`` scenes (by default
:func:`default_scene_chunk`); every chunk's tiles go through one model call,
and the chunks are joined before the level's modal correction, so the gains'
fits still see every scene. Eval-mode BatchNorm is per sample, so this
computes what the JAX package's ``lax.map`` over scenes does, and the device
memory of a level grows with the chunk, not with the scene count.

``tile_devices`` (the JAX package's ``tile_sharding``) splits the tile batch of
every model call into contiguous parts over a list of devices
(:class:`TileSplit`): each part runs on its own replica of the level's expert,
and the outputs are gathered onto the fields' device in order. A list of one
device, the fields' own, is the unsplit call.

:func:`plan_cascade` resolves a cascade's arguments once into a
:class:`CascadePlan` of :class:`CascadeLevel` records, which
:func:`level_program` runs one at a time: :func:`ml_cascade` in order;
:func:`ml_cascade_stepwise` the same, synchronising after each level, so each
level's wall time is observable (the statistical harness's timings);
:func:`calibrate_amplitude` fits one amplitude per level on self-generated
scenes (the modal gains are :func:`~.modal.calibrate_modal`'s).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
import time
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call

from superresolution_for_pdes_tpu_torch.cascade.graphs import LEVEL_GRAPHS
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
from superresolution_for_pdes_tpu_torch.device import synchronize
from superresolution_for_pdes_tpu_torch.ops.resize import resize_align_corners
from superresolution_for_pdes_tpu_torch.solver.multigrid import vcycle
from superresolution_for_pdes_tpu_torch.utils.profiling import span

STATS_MODES = ("oracle", "scene", "train", "tile")

# Fine grid points (tiles x fine-tile area, x8 with symmetrize) that one model
# call takes by default. The champion's deepest level (320 -> 640 in 16 tiles
# of 160^2) has 409,600 points per scene and held 1.3 GiB of device memory per
# scene in one call (PERF.md section 5), so 2^22 points, 10 such scenes, keep
# a level near 13 GiB however many scenes it runs; a call of 160 tiles of 160^2
# is still a large batch for the card, and the shallow levels (6,400 points
# per scene at 40 -> 80) stay one call up to 655 scenes.
SCENE_CHUNK_POINTS = 1 << 22


def apply_model(model: nn.Module, weights, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode forward of ``model``'s architecture with ``weights``."""
    if weights is None:
        return model(x)
    if isinstance(weights, nn.Module):
        return weights(x)
    return functional_call(model, dict(weights), (x,))


class TileSplit:
    """A model call's tile batch split into contiguous parts, one per device
    of ``devices``, each run on a replica of the expert made once per device
    (and per expert) and kept; the parts' outputs are joined on the input's
    device in order. A part on the input's own device runs the given model
    and weights themselves."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("TileSplit needs at least one device")
        self._replicas: Dict[tuple, tuple] = {}

    def _replica(self, model: nn.Module, weights, device: torch.device):
        key = (id(model), id(weights), device)
        if key not in self._replicas:
            if isinstance(weights, Mapping):
                replica = (copy.deepcopy(model).to(device),
                           {k: v.to(device) for k, v in weights.items()})
            else:  # the module itself (weights None) or a module of weights
                source = model if weights is None else weights
                replica = (model, copy.deepcopy(source).to(device).eval())
            self._replicas[key] = replica
        return self._replicas[key]

    def __call__(self, model: nn.Module, weights, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for part, device in zip(torch.tensor_split(x, len(self.devices)), self.devices):
            if device == x.device:
                outs.append(apply_model(model, weights, part))
            else:
                outs.append(apply_model(*self._replica(model, weights, device),
                                        part.to(device)).to(x.device))
        return outs[0] if len(outs) == 1 else torch.cat(outs)


def _apply_split(model, weights, x: torch.Tensor, split: Optional[TileSplit]) -> torch.Tensor:
    return apply_model(model, weights, x) if split is None else split(model, weights, x)


def dihedral_apply(model, weights, x: torch.Tensor,
                   split: Optional[TileSplit] = None) -> torch.Tensor:
    """Average the model over the 8 symmetries of the square (test-time
    ensembling), as one model call over an 8x larger batch. ``x`` is NCHW."""
    xs = []
    for flip in (False, True):
        xf = torch.flip(x, dims=(-2,)) if flip else x
        for k in range(4):
            xs.append(torch.rot90(xf, k, dims=(-2, -1)))
    preds = torch.chunk(_apply_split(model, weights, torch.cat(xs, dim=0), split), 8, dim=0)
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
    with span("cascade.refine", cycles):
        b = -(f / theta)
        for _ in range(cycles):
            u = vcycle(u, b, use_kernels=use_kernels)
        return u


def _per_level(value, i: int):
    """Level ``i``'s entry of a setting given once for every level, or as a
    list or tuple of one per level (trailing levels reuse the last)."""
    if isinstance(value, (list, tuple)):
        return value[min(i, len(value) - 1)]
    return value


# Marks a field that a level's graph key holds by identity or address; every
# other field of a plan or a level is one of the key's settings.
_KEYED_APART = {"setting": False}


class _Record:
    @functools.cached_property
    def settings(self) -> tuple:
        """The fields not marked ``_KEYED_APART``, read once per record: a
        plan's and a level's are the ``settings`` of the level's graph key."""
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if f.metadata.get("setting", True))


@dataclasses.dataclass(frozen=True, eq=False)
class CascadeLevel(_Record):
    """Level ``index`` of a plan, to ``res``: its tiling, weights and gains."""

    index: int
    res: int
    coarse_tile: int
    overlap: bool
    weights: object = dataclasses.field(metadata=_KEYED_APART)
    gains: object = dataclasses.field(metadata=_KEYED_APART)


@dataclasses.dataclass(frozen=True, eq=False)
class CascadePlan(_Record):
    """A cascade's arguments as :func:`plan_cascade` resolves them."""

    model: nn.Module = dataclasses.field(metadata=_KEYED_APART)
    stats_mode: str
    train_stats: Optional[NormStats] = dataclasses.field(metadata=_KEYED_APART)
    symmetrize: bool
    refine_cycles: int
    use_kernels: bool | None
    scene_chunk: int | None
    split: Optional[TileSplit] = dataclasses.field(metadata=_KEYED_APART)
    levels: Tuple[CascadeLevel, ...] = dataclasses.field(metadata=_KEYED_APART)


def plan_cascade(model: nn.Module, variables, start_resolution: int, target_resolution: int,
                 stats_mode: str = "scene", train_stats: Optional[NormStats] = None,
                 coarse_tile=20, overlap=False, symmetrize: bool = False,
                 refine_cycles: int = 0, amp_levels=None, use_kernels: bool | None = None,
                 scene_chunk: int | None = None, tile_devices=None) -> CascadePlan:
    """The cascade from ``start_resolution`` to ``target_resolution`` as a
    plan (arguments as for :func:`ml_cascade`; the tile, the overlap and the
    weights once or per level, by :func:`_per_level`). Checks the stats mode
    and the weights, and puts the model and any module of weights in eval
    mode."""
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
    levels = tuple(
        CascadeLevel(i, res, int(_per_level(coarse_tile, i)), bool(_per_level(overlap, i)),
                     _per_level(variables, i), None if amp_levels is None else amp_levels[i])
        for i, res in enumerate(level_resolutions(start_resolution, target_resolution)))
    if tile_devices is not None and not isinstance(tile_devices, TileSplit):
        tile_devices = TileSplit(tile_devices)
    return CascadePlan(model, stats_mode, train_stats, symmetrize, refine_cycles, use_kernels,
                       scene_chunk, tile_devices, levels)


def _level_body(plan: CascadePlan, level: CascadeLevel, current: torch.Tensor,
                f_next: torch.Tensor, theta_next: torch.Tensor,
                stats_field: torch.Tensor) -> torch.Tensor:
    """One cascade level on ``(..., r, r)`` fields (optional leading scene
    axis); the ``"scene"`` and ``"oracle"`` modes take ``stats_field``'s stats."""
    coarse_tile, overlap = level.coarse_tile, level.overlap
    fine_tile = 2 * coarse_tile
    next_res = f_next.shape[-1]
    c_stride = coarse_tile // 2 if overlap else coarse_tile
    per_axis = (current.shape[-1] - coarse_tile) // c_stride + 1
    n_tiles = math.prod(current.shape[:-2]) * per_axis ** 2
    with span("cascade.inputs", n_tiles):
        if plan.stats_mode == "tile":
            stats = None
        elif plan.stats_mode == "train":
            stats = plan.train_stats
        else:  # per-scene stats, shaped to broadcast over the tile axis
            stats = NormStats.from_fields(stats_field.unsqueeze(-3), f_next.unsqueeze(-3),
                                          theta_next.unsqueeze(-3), dims=(-2, -1))
        if overlap:
            u_tiles, f_tiles, theta_tiles = (
                split_tiles_overlapping(current, coarse_tile, c_stride),
                split_tiles_overlapping(f_next, fine_tile, 2 * c_stride),
                split_tiles_overlapping(theta_next, fine_tile, 2 * c_stride))
        else:
            u_tiles, f_tiles, theta_tiles = (split_tiles(current, coarse_tile),
                                             split_tiles(f_next, fine_tile),
                                             split_tiles(theta_next, fine_tile))
        st = per_sample_stats(u_tiles, f_tiles, theta_tiles) if stats is None else stats
        x = make_model_inputs(u_tiles, f_tiles, theta_tiles, st,
                              fine_shape=(fine_tile, fine_tile),
                              scale_channels=plan.model.in_channels > 3)
    with span("cascade.model", n_tiles):  # one call over the tiles flattened to one batch
        apply = dihedral_apply if plan.symmetrize else _apply_split
        pred = apply(plan.model, level.weights, x.reshape((-1,) + x.shape[-3:]), plan.split)
        pred = pred.reshape(x.shape[:-3] + pred.shape[-3:])
    with span("cascade.stitch", n_tiles):
        up_tiles = st.denormalize_u(pred[..., 0, :, :])
        out = (stitch_tiles_overlapping(up_tiles, next_res, 2 * c_stride) if overlap
               else stitch_tiles(up_tiles))
    if plan.refine_cycles > 0:
        out = _refine(out, f_next, theta_next, plan.refine_cycles, plan.use_kernels)
    return out


def default_scene_chunk(n_scenes: int, res: int, coarse_tile: int, overlap: bool,
                        symmetrize: bool = False) -> int:
    """Scenes per model call at a level whose input is ``res``: as few calls
    as keep each within :data:`SCENE_CHUNK_POINTS` fine points, with the
    scenes spread evenly over them."""
    per_axis = ((res - coarse_tile) // (coarse_tile // 2) + 1 if overlap
                else res // coarse_tile)
    points = per_axis ** 2 * (2 * coarse_tile) ** 2 * (8 if symmetrize else 1)
    calls = max(1, -(-n_scenes * points // SCENE_CHUNK_POINTS))
    return -(-n_scenes // calls)


def level_resolutions(start: int, target: int) -> tuple[int, ...]:
    """The resolutions the cascade reaches from ``start`` to ``target``, doubling."""
    res, out = start, []
    while res < target:
        res *= 2
        out.append(res)
    return tuple(out)


def level_program(plan: CascadePlan, level: CascadeLevel, current: torch.Tensor,
                  data: Dict) -> torch.Tensor:
    """``level`` of ``plan`` on ``current`` (one field or a scene batch) with
    ``data``'s f and theta at the level's resolution (and its u, for the
    oracle stats), then the level's gains if it has them. A scene batch runs
    ``plan.scene_chunk`` scenes per model call (default
    :func:`default_scene_chunk`); the plan's :class:`TileSplit` splits each
    call's tiles over devices. Runs under ``torch.no_grad()``.

    One scene on a card, with its tiles on its own device, is replayed as a
    CUDA graph from the third call with the same key on
    (:mod:`~superresolution_for_pdes_tpu_torch.cascade.graphs`), with the
    same bits; a scene batch, CPU tensors and a split over other devices run
    eagerly."""
    res, stats_mode = level.res, plan.stats_mode
    inputs = (current, data["f"][res], data["theta"][res],
              data["u"][res] if stats_mode == "oracle" else None)

    def program(current, f, theta, oracle):
        source = oracle if stats_mode == "oracle" else current

        def body(sl):
            return _level_body(plan, level, current[sl], f[sl], theta[sl], source[sl])

        if current.ndim == 2:
            out = body(slice(None))
        else:
            n = current.shape[0]
            chunk = plan.scene_chunk or default_scene_chunk(
                n, current.shape[-1], level.coarse_tile, level.overlap, plan.symmetrize)
            parts = [body(slice(s, s + chunk)) for s in range(0, n, chunk)]
            out = parts[0] if len(parts) == 1 else torch.cat(parts)
        return out if level.gains is None else apply_level_correction(out, level.gains)

    with torch.no_grad(), span("cascade.level", res):
        read = [level.gains] + (list(vars(plan.train_stats).values())
                                if stats_mode == "train" else [])
        key = LEVEL_GRAPHS.key(plan.model, level.weights, level.index, inputs,
                               (plan.settings, level.settings), read,
                               None if plan.split is None else plan.split.devices)
        if key is None:
            return program(*inputs)
        return LEVEL_GRAPHS.run(key, level.index, program, inputs)


def _level_fields(plan: CascadePlan, data: Dict,
                  current: torch.Tensor) -> Iterator[Tuple[int, torch.Tensor]]:
    """``(resolution, field)`` of each level of ``plan`` in turn, from
    ``current``."""
    for level in plan.levels:
        current = level_program(plan, level, current, data)
        yield level.res, current


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
    scene_chunk: int | None = None,
    tile_devices=None,
) -> Tuple[Dict[int, torch.Tensor], Dict[int, float]]:
    """The cascade one level at a time, returning ``(fields by resolution,
    wall seconds by resolution)``: each level ends in a device synchronisation,
    so the cumulative sum of the level times is the time to reach each
    resolution from one pass. The fields are :func:`ml_cascade`'s, bit for
    bit (arguments as there)."""
    plan = plan_cascade(
        model, variables, start_resolution, target_resolution, stats_mode=stats_mode,
        train_stats=train_stats, coarse_tile=coarse_tile, overlap=overlap,
        symmetrize=symmetrize, refine_cycles=refine_cycles, amp_levels=amp_levels,
        use_kernels=use_kernels, scene_chunk=scene_chunk, tile_devices=tile_devices)
    outs: Dict[int, torch.Tensor] = {}
    times: Dict[int, float] = {}
    t0 = time.perf_counter()
    for res, current in _level_fields(plan, data, data["u"][start_resolution]):
        synchronize(current.device)
        times[res] = time.perf_counter() - t0
        outs[res] = current
        t0 = time.perf_counter()
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
    package's warmup costs none. Where ``data`` is that one scene, on a card,
    it runs twice, so that the levels are captured as CUDA graphs and the
    timed pass replays them.
    """
    first = {key: {r: (v[:1] if v.ndim == 3 else v) for r, v in data[key].items()}
             for key in ("u", "f", "theta")}
    u0 = data["u"][start_resolution]
    if kwargs.get("refine_cycles", 0) > 0 and u0.is_cuda:
        from superresolution_for_pdes_tpu_torch.ops.stencil_kernels import load_kernels

        load_kernels()
    for _ in range(2 if u0.is_cuda and (u0.ndim == 2 or len(u0) == 1) else 1):
        ml_cascade_stepwise(model, variables, first, target_resolution,
                            start_resolution=start_resolution, **kwargs)


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
    scene_chunk: int | None = None,
    tile_devices=None,
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
    ``use_kernels`` is passed to the refinement's V-cycles; ``scene_chunk``
    is the scenes per model call (default :func:`default_scene_chunk`);
    ``tile_devices`` splits each call's tiles over a device list
    (:class:`TileSplit`).
    """
    plan = plan_cascade(
        model, variables, start_resolution, target_resolution, stats_mode=stats_mode,
        train_stats=train_stats, coarse_tile=coarse_tile, overlap=overlap,
        symmetrize=symmetrize, refine_cycles=refine_cycles, amp_levels=amp_levels,
        use_kernels=use_kernels, scene_chunk=scene_chunk, tile_devices=tile_devices)
    current = data["u"][start_resolution]
    with span("cascade", 1 if current.ndim == 2 else current.shape[0]):
        return dict(_level_fields(plan, data, current))


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
    plan = plan_cascade(model, variables, start_resolution, target_resolution,
                        stats_mode=stats_mode, train_stats=train_stats,
                        coarse_tile=coarse_tile, overlap=overlap, symmetrize=symmetrize)
    current = scenes["u"][start_resolution]
    amps = []
    for level in plan.levels:
        pred = level_program(plan, level, current, scenes)
        truth_std = torch.std(scenes["u"][level.res], dim=(-2, -1), correction=0)
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
