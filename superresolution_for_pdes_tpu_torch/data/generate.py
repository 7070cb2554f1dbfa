"""On-device dataset generation (port of ``data/generate.py``).

Every sample is solved exactly, batched over the sample axis, with the DST
solver (``refine_iters=1``):

* standard samples: ``k1, k2 ~ U(k_range)``, ``f = sin(2 pi k1 X) sin(2 pi k2 Y)``
  on separate (non-nested) ``linspace(0, 1, n)`` grids at 20^2 and 40^2, and
  ``diag(theta) L u = f`` solved on both; ``theta_coarse`` is
  ``theta_fine[::2, ::2]`` (all ones for constant theta);
* subdomain samples: one 80^2 solve, a 40^2 window at origin
  ``randint(0, 40)`` per axis, and its ``[::2, ::2]`` stride as the 20^2 coarse
  fields;
* cascade tiles: multi-resolution scenes (the finest f and theta strided to
  every level, each level solved), and per level pair ``r -> 2r`` matched
  windows: ``tile`` points at r (origin ``randint(0, r - tile + 1)``) and the
  ``2 tile`` points at 2r from twice that origin;
* self-fed cascade tiles: the same pairs, but the coarse input at every
  level above the coarsest is a frozen teacher cascade's own prediction;
* test sets: standard geometry with theta ones or ``U(0.5, 2)``.

Each generator is split in two. A sampling step draws ``k1``, ``k2``, theta
and the window origins with a ``torch.Generator`` on the device (an int seed
makes one there; the device defaults to ``cuda`` and raises without a card).
A deterministic step (``*_from_params``, :func:`_tile_pairs_from_levels`)
takes them explicitly, so draws made elsewhere (the JAX package's) can be fed
in. A seed does not give the JAX package's samples: the two random generators
differ, and the port draws the parts of a mixed set one after another from
one generator where JAX splits keys.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from superresolution_for_pdes_tpu_torch.device import resolve_device
from superresolution_for_pdes_tpu_torch.ops.grid import forcing_term
from superresolution_for_pdes_tpu_torch.solver.dst import solve_poisson_dst

THETA_RANGE = (0.5, 2.0)

Dataset = Dict[str, torch.Tensor]


def make_generator(seed_or_generator, device=None) -> torch.Generator:
    """A ``torch.Generator`` as given, or one on ``device`` (default ``cuda``)
    seeded with an int."""
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    gen = torch.Generator(device=resolve_device(device))
    return gen.manual_seed(int(seed_or_generator))


def fold_in(gen: torch.Generator, data: int) -> torch.Generator:
    """A generator on ``gen``'s device seeded by a pure function of ``gen``'s
    seed and ``data`` (the JAX package's ``jax.random.fold_in``): draws from
    ``gen`` do not change it."""
    state = np.random.SeedSequence([gen.initial_seed(), data]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=gen.device).manual_seed(int(state))


def uniform(gen: torch.Generator, shape, lo: float, hi: float, dtype) -> torch.Tensor:
    """``shape`` draws from U(``lo``, ``hi``) in ``dtype`` on ``gen``'s device."""
    return torch.rand(shape, generator=gen, dtype=dtype, device=gen.device) * (hi - lo) + lo


def _randint(gen: torch.Generator, shape, lo: int, hi: int) -> torch.Tensor:
    """Integers in ``[lo, hi)``."""
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


def _wave_numbers(gen: torch.Generator, n: int, k_range, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    lo, hi = k_range
    return uniform(gen, (n,), lo, hi, dtype), uniform(gen, (n,), lo, hi, dtype)


def _theta_fields(gen: torch.Generator, n_samples: int, n: int, constant_theta: bool,
                  dtype) -> torch.Tensor:
    """``(n_samples, n, n)`` theta: ones, or pointwise ``U(0.5, 2)``."""
    if constant_theta:
        return torch.ones((n_samples, n, n), dtype=dtype, device=gen.device)
    return uniform(gen, (n_samples, n, n), *THETA_RANGE, dtype)


def _windows(field: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, size: int) -> torch.Tensor:
    """``(size, size)`` windows of ``field (B, n, n)`` at origins ``oy``/``ox``
    of shape ``(B,)`` or ``(B, T)``; the result is ``oy.shape + (size, size)``."""
    ar = torch.arange(size, device=field.device)
    rows = (oy[..., None] + ar)[..., :, None]
    cols = (ox[..., None] + ar)[..., None, :]
    batch = torch.arange(field.shape[0], device=field.device)
    return field[batch.reshape((-1,) + (1,) * (oy.ndim + 1)), rows, cols]


def _flags(n: int, value: bool, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=torch.bool, device=device)


# ------------------------------------------------------- standard / test sets
def standard_from_params(k1: torch.Tensor, k2: torch.Tensor, theta_fine: torch.Tensor,
                         n_coarse: int = 20, refine_iters: int = 1) -> Dataset:
    """Deterministic step of :func:`generate_standard_dataset`: ``k1``, ``k2``
    ``(B,)`` and ``theta_fine (B, n_fine, n_fine)``."""
    n_fine = theta_fine.shape[-1]
    dtype, device = theta_fine.dtype, theta_fine.device
    f_fine = forcing_term(k1, k2, n_fine, dtype, device)
    f_coarse = forcing_term(k1, k2, n_coarse, dtype, device)
    theta_coarse = theta_fine[:, ::2, ::2].contiguous()
    return {
        "u_fine": solve_poisson_dst(f_fine, theta_fine, refine_iters),
        "u_coarse": solve_poisson_dst(f_coarse, theta_coarse, refine_iters),
        "f_fine": f_fine,
        "f_coarse": f_coarse,
        "theta_fine": theta_fine,
        "theta_coarse": theta_coarse,
        "k1": k1,
        "k2": k2,
        "is_subdomain": _flags(k1.shape[0], False, device),
    }


def generate_standard_dataset(seed_or_generator, n_samples: int,
                              k_range: Tuple[float, float] = (0.5, 5.0), dtype=torch.float32,
                              constant_theta: bool = True, n_coarse: int = 20, n_fine: int = 40,
                              refine_iters: int = 1, device=None) -> Dataset:
    """Standard samples; published defaults 1000 samples, k in (0.5, 5.0),
    theta == 1."""
    gen = make_generator(seed_or_generator, device)
    k1, k2 = _wave_numbers(gen, n_samples, k_range, dtype)
    theta_fine = _theta_fields(gen, n_samples, n_fine, constant_theta, dtype)
    return standard_from_params(k1, k2, theta_fine, n_coarse, refine_iters)


def generate_test_dataset(seed_or_generator, n_samples: int, k_range: Tuple[float, float],
                          constant_theta: bool = True, dtype=torch.float32,
                          refine_iters: int = 1, device=None) -> Dataset:
    """Evaluation sets: standard geometry, theta ones or ``U(0.5, 2)``."""
    return generate_standard_dataset(seed_or_generator, n_samples, k_range, dtype=dtype,
                                     constant_theta=constant_theta,
                                     refine_iters=refine_iters, device=device)


# ------------------------------------------------------------ subdomain sets
def subdomain_from_params(k1: torch.Tensor, k2: torch.Tensor, theta_superfine: torch.Tensor,
                          origins: torch.Tensor, n_fine: int = 40,
                          refine_iters: int = 1) -> Dataset:
    """Deterministic step of :func:`generate_subdomain_dataset`: the superfine
    theta ``(B, N, N)`` and the window origins ``(B, 2)`` as ``(y, x)``."""
    n_sf = theta_superfine.shape[-1]
    f_sf = forcing_term(k1, k2, n_sf, theta_superfine.dtype, theta_superfine.device)
    u_sf = solve_poisson_dst(f_sf, theta_superfine, refine_iters)
    oy, ox = origins[:, 0], origins[:, 1]
    u_fine, f_fine, theta_fine = (_windows(x, oy, ox, n_fine)
                                  for x in (u_sf, f_sf, theta_superfine))
    return {
        "u_fine": u_fine,
        "u_coarse": u_fine[:, ::2, ::2].contiguous(),
        "f_fine": f_fine,
        "f_coarse": f_fine[:, ::2, ::2].contiguous(),
        "theta_fine": theta_fine,
        "theta_coarse": theta_fine[:, ::2, ::2].contiguous(),
        "k1": k1,
        "k2": k2,
        "is_subdomain": _flags(k1.shape[0], True, theta_superfine.device),
    }


def generate_subdomain_dataset(seed_or_generator, n_samples: int,
                               k_range: Tuple[float, float] = (0.5, 12.0), dtype=torch.float32,
                               constant_theta: bool = True, n_superfine: int = 80,
                               n_fine: int = 40, refine_iters: int = 1, device=None) -> Dataset:
    """Subdomain samples; published default k range (0.5, 12.0)."""
    gen = make_generator(seed_or_generator, device)
    k1, k2 = _wave_numbers(gen, n_samples, k_range, dtype)
    theta_sf = _theta_fields(gen, n_samples, n_superfine, constant_theta, dtype)
    origins = _randint(gen, (n_samples, 2), 0, n_superfine - n_fine)
    return subdomain_from_params(k1, k2, theta_sf, origins, n_fine, refine_iters)


# ------------------------------------------------------------------- mixing
def combine_datasets(a: Dataset, b: Dataset) -> Dataset:
    """Concatenate two dataset dicts sample-wise. An empty side contributes
    nothing and may carry other spatial dims, so it is skipped."""
    if set(a) != set(b):
        raise ValueError(f"dataset key mismatch: {sorted(set(a) ^ set(b))}")
    if int(a["u_fine"].shape[0]) == 0:
        return b
    if int(b["u_fine"].shape[0]) == 0:
        return a
    return {k: torch.cat([a[k], b[k]], dim=0) for k in a}


def generate_enhanced_dataset(seed_or_generator, n_standard: int, n_subdomain: int,
                              standard_k_range: Tuple[float, float] = (0.5, 5.0),
                              subdomain_k_range: Tuple[float, float] = (0.5, 12.0),
                              constant_theta: bool = True, dtype=torch.float32,
                              refine_iters: int = 1, device=None) -> Dataset:
    """The published training mix: standard then subdomain samples."""
    gen = make_generator(seed_or_generator, device)
    parts = []
    if n_standard > 0:
        parts.append(generate_standard_dataset(
            gen, n_standard, standard_k_range, dtype=dtype,
            constant_theta=constant_theta, refine_iters=refine_iters))
    if n_subdomain > 0:
        parts.append(generate_subdomain_dataset(
            gen, n_subdomain, subdomain_k_range, dtype=dtype,
            constant_theta=constant_theta, refine_iters=refine_iters))
    if not parts:
        raise ValueError("n_standard + n_subdomain must be > 0")
    return functools.reduce(combine_datasets, parts)


def generate_mixed_dataset(seed_or_generator, n_standard: int = 1000, n_subdomain: int = 1000,
                           theta: str = "constant",
                           standard_k_range: Tuple[float, float] = (0.5, 5.0),
                           subdomain_k_range: Tuple[float, float] = (0.5, 12.0),
                           n_cascade_scenes: int = 0, cascade_tiles_per_level: int = 8,
                           cascade_k_range: Tuple[float, float] = (0.5, 12.0),
                           cascade_finest: int = 640, cascade_coarsest: int = 40,
                           cascade_tile_size: int = 20, dtype=torch.float32,
                           device=None) -> Dataset:
    """One-call training-set recipe (shared by the generate_data and train
    CLIs). ``theta``: ``"constant"`` (ones), ``"varying"`` (pointwise
    ``U(0.5, 2)``) or ``"mixed"`` (both strata, constant first). Cascade
    tiles, if any, come last, with varying theta unless ``theta`` is
    ``"constant"``."""
    if (cascade_tile_size != 20 and n_cascade_scenes > 0
            and (n_standard > 0 or n_subdomain > 0)):
        raise ValueError(
            "cascade_tile_size != 20 cannot be mixed with standard/subdomain "
            "samples (their 20^2->40^2 geometry has different sample shapes); "
            "set n_standard = n_subdomain = 0 for a bigger-window expert")
    if theta not in ("mixed", "constant", "varying"):
        raise ValueError(f"unknown theta mode: {theta!r}")
    gen = make_generator(seed_or_generator, device)
    enhanced = functools.partial(generate_enhanced_dataset, gen, n_standard, n_subdomain,
                                 standard_k_range, subdomain_k_range, dtype=dtype)
    if n_standard + n_subdomain == 0:
        dataset = None
    elif theta == "mixed":
        dataset = combine_datasets(enhanced(constant_theta=True),
                                   enhanced(constant_theta=False))
    else:
        dataset = enhanced(constant_theta=theta == "constant")
    if n_cascade_scenes > 0:
        cascade = generate_cascade_dataset(
            gen, n_cascade_scenes, tiles_per_level=cascade_tiles_per_level,
            k_range=cascade_k_range, finest=cascade_finest, coarsest=cascade_coarsest,
            constant_theta=theta == "constant", dtype=dtype, tile_size=cascade_tile_size)
        dataset = cascade if dataset is None else combine_datasets(dataset, cascade)
    if dataset is None:
        raise ValueError("empty dataset recipe: set n_standard, n_subdomain or "
                         "n_cascade_scenes > 0")
    return dataset


# ------------------------------------------------------------ cascade tiles
def cascade_resolutions(coarsest: int, finest: int) -> List[int]:
    """``coarsest, 2 coarsest, ...`` up to ``finest``."""
    resolutions, r = [], coarsest
    while r <= finest:
        resolutions.append(r)
        r *= 2
    return resolutions


def cascade_scene_fields_from_params(k1: torch.Tensor, k2: torch.Tensor,
                                     theta_finest: torch.Tensor, coarsest: int = 40,
                                     refine_iters: int = 1):
    """Deterministic step of :func:`_cascade_scene_fields`: exact solves at
    every level of the strided finest f and theta. Returns
    ``({"f", "theta", "u"}: {res: (B, res, res)}, resolutions)``."""
    finest = theta_finest.shape[-1]
    f_finest = forcing_term(k1, k2, finest, theta_finest.dtype, theta_finest.device)
    resolutions = cascade_resolutions(coarsest, finest)
    fields = {"f": {}, "theta": {}, "u": {}}
    for res in resolutions:
        step = finest // res
        f_r = f_finest[:, ::step, ::step].contiguous()
        t_r = theta_finest[:, ::step, ::step].contiguous()
        fields["f"][res] = f_r
        fields["theta"][res] = t_r
        fields["u"][res] = solve_poisson_dst(f_r, t_r, refine_iters)
    return fields, resolutions


def _cascade_scene_fields(gen: torch.Generator, n_scenes: int, finest: int,
                          k_range: Tuple[float, float], constant_theta: bool, dtype,
                          refine_iters: int, coarsest: int = 40):
    """Batched multi-resolution scenes: ``(fields, resolutions, k1, k2)``."""
    k1, k2 = _wave_numbers(gen, n_scenes, k_range, dtype)
    theta_finest = _theta_fields(gen, n_scenes, finest, constant_theta, dtype)
    fields, resolutions = cascade_scene_fields_from_params(k1, k2, theta_finest, coarsest,
                                                           refine_iters)
    return fields, resolutions, k1, k2


def sample_tile_origins(gen: torch.Generator, n_scenes: int, resolutions: Sequence[int],
                        tiles_per_level: int, coarse_tile: int = 20) -> List[torch.Tensor]:
    """Per level pair ``r -> 2r``, origins ``(n_scenes, tiles, 2)`` on the r
    grid in ``[0, r - coarse_tile]``."""
    return [_randint(gen, (n_scenes, tiles_per_level, 2), 0, res - coarse_tile + 1)
            for res in resolutions[:-1]]


def _tile_pairs_from_levels(origins: Sequence[torch.Tensor],
                            fields_coarse: Dict[int, torch.Tensor],
                            fields_exact: Dict[int, torch.Tensor],
                            f: Dict[int, torch.Tensor], theta: Dict[int, torch.Tensor],
                            resolutions: Sequence[int], k1: torch.Tensor, k2: torch.Tensor,
                            coarse_tile: int = 20) -> Dataset:
    """Matched (``coarse_tile`` @ r, ``2 coarse_tile`` @ 2r) window pairs per
    level pair and scene, at the given origins (one ``(n_scenes, T, 2)``
    tensor per pair). The r grid is the ``[::2, ::2]`` subset of the 2r grid,
    so the coarse window at ``(oy, ox)`` matches the fine one at
    ``(2 oy, 2 ox)``; ``u_coarse`` comes from ``fields_coarse``."""
    fine_tile = 2 * coarse_tile
    out = {k: [] for k in ("u_fine", "u_coarse", "f_fine", "f_coarse", "theta_fine",
                           "theta_coarse", "k1", "k2")}
    for i, res in enumerate(resolutions[:-1]):
        nxt = resolutions[i + 1]
        oy, ox = origins[i][..., 0], origins[i][..., 1]
        tiles = origins[i].shape[1]

        def pair(field_r, field_2r):
            c = _windows(field_r, oy, ox, coarse_tile).flatten(0, 1)
            fi = _windows(field_2r, 2 * oy, 2 * ox, fine_tile).flatten(0, 1)
            return c, fi

        for name, src_c, src_f in (("u", fields_coarse, fields_exact), ("f", f, f),
                                   ("theta", theta, theta)):
            c, fi = pair(src_c[res], src_f[nxt])
            out[f"{name}_coarse"].append(c)
            out[f"{name}_fine"].append(fi)
        out["k1"].append(torch.repeat_interleave(k1, tiles))
        out["k2"].append(torch.repeat_interleave(k2, tiles))
    ds = {k: torch.cat(v, dim=0) for k, v in out.items()}
    ds["is_subdomain"] = _flags(ds["u_fine"].shape[0], True, ds["u_fine"].device)
    return ds


def cascade_from_params(k1: torch.Tensor, k2: torch.Tensor, theta_finest: torch.Tensor,
                        origins: Sequence[torch.Tensor], coarsest: int = 40,
                        tile_size: int = 20, refine_iters: int = 1) -> Dataset:
    """Deterministic step of :func:`generate_cascade_dataset`."""
    fields, resolutions = cascade_scene_fields_from_params(k1, k2, theta_finest, coarsest,
                                                           refine_iters)
    return _tile_pairs_from_levels(origins, fields["u"], fields["u"], fields["f"],
                                   fields["theta"], resolutions, k1, k2, coarse_tile=tile_size)


def generate_cascade_dataset(seed_or_generator, n_scenes: int, tiles_per_level: int = 8,
                             k_range: Tuple[float, float] = (0.5, 12.0), finest: int = 640,
                             coarsest: int = 40, constant_theta: bool = True,
                             dtype=torch.float32, refine_iters: int = 1, tile_size: int = 20,
                             device=None) -> Dataset:
    """Cascade-consistent training tiles: for every level pair ``r -> 2r`` of a
    multi-resolution scene, ``tiles_per_level`` window pairs whose coarse input
    is a window of the independent r-grid solve. ``tile_size`` is the coarse
    window (fine windows are twice it)."""
    gen = make_generator(seed_or_generator, device)
    fields, resolutions, k1, k2 = _cascade_scene_fields(
        gen, n_scenes, finest, k_range, constant_theta, dtype, refine_iters, coarsest=coarsest)
    origins = sample_tile_origins(gen, n_scenes, resolutions, tiles_per_level, tile_size)
    return _tile_pairs_from_levels(origins, fields["u"], fields["u"], fields["f"],
                                   fields["theta"], resolutions, k1, k2, coarse_tile=tile_size)


def _harvested(resolutions: List[int], harvest_from: int | None) -> List[int]:
    """The resolutions whose pairs are harvested: those ``>= harvest_from``."""
    if harvest_from is None:
        return resolutions
    harvested = [r for r in resolutions if r >= harvest_from]
    if len(harvested) < 2:
        raise ValueError(f"harvest_from={harvest_from} leaves no (coarse, fine) pair "
                         f"in resolutions {resolutions}")
    return harvested


def selffeed_from_params(model, variables, k1: torch.Tensor, k2: torch.Tensor,
                         theta_finest: torch.Tensor, origins: Sequence[torch.Tensor],
                         stats_mode: str = "scene", refine_iters: int = 1, amp_levels=None,
                         harvest_from: int | None = None, overlap=False, tile_size: int = 20,
                         teacher_tile=20) -> Dataset:
    """Deterministic step of :func:`selffeed_cascade_dataset`: one origins
    tensor ``(B, T, 2)`` per harvested level pair."""
    from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade

    fields, resolutions = cascade_scene_fields_from_params(k1, k2, theta_finest,
                                                           refine_iters=refine_iters)
    r0 = resolutions[0]
    harvested = _harvested(resolutions, harvest_from)
    if len(origins) != len(harvested) - 1:
        raise ValueError(f"{len(origins)} origin tensors for the {len(harvested) - 1} "
                         f"harvested level pairs of {harvested}")
    # oracle stats read the truth at every level; the honest modes read only
    # the cascade's start field
    scene = {"u": fields["u"] if stats_mode == "oracle" else {r0: fields["u"][r0]},
             "f": fields["f"], "theta": fields["theta"]}
    # the teacher runs to the deepest coarse input, one level above the finest
    # target, and not at all for a single pair (its input is the exact solve)
    u_inputs = {r0: fields["u"][r0]}
    if resolutions[-2] > r0:
        preds = ml_cascade(model, variables, scene, resolutions[-2], stats_mode=stats_mode,
                           amp_levels=amp_levels, overlap=overlap, coarse_tile=teacher_tile)
        u_inputs.update(preds)
    return _tile_pairs_from_levels(origins, u_inputs, fields["u"], fields["f"],
                                   fields["theta"], harvested, k1, k2, coarse_tile=tile_size)


def selffeed_cascade_dataset(model, variables, seed_or_generator, n_scenes: int,
                             tiles_per_level: int = 8, k_range: Tuple[float, float] = (0.5, 12.0),
                             finest: int = 640, constant_theta: bool = False,
                             stats_mode: str = "scene", dtype=torch.float32,
                             refine_iters: int = 1, amp_levels=None,
                             harvest_from: int | None = None, overlap=False,
                             tile_size: int = 20, teacher_tile=20,
                             scene_chunk: int | None = None, device=None) -> Dataset:
    """Self-feeding cascade tiles: the coarse inputs are the given (frozen)
    model's own cascade predictions, the targets exact solves.

    Fresh multi-resolution scenes go through the teacher cascade (``model``,
    ``variables``: one set of weights or one per level; ``amp_levels``,
    ``overlap`` and ``teacher_tile`` as the cascade takes them, a value or a
    per-level sequence), and every level pair ``r -> 2r`` yields
    ``tiles_per_level`` (prediction @ r, exact @ 2r) window pairs of
    ``tile_size`` coarse points. ``harvest_from`` keeps only the pairs whose
    coarse resolution is at least that. ``scene_chunk`` generates the scenes
    in chunks of that many (it must divide ``n_scenes``), each drawing its
    own scenes and origins from the generator in turn, so the solves' memory
    follows the chunk; the teacher's model calls are chunked by the cascade
    itself in any case."""
    gen = make_generator(seed_or_generator, device)
    kw = dict(tiles_per_level=tiles_per_level, k_range=k_range, finest=finest,
              constant_theta=constant_theta, stats_mode=stats_mode, dtype=dtype,
              refine_iters=refine_iters, amp_levels=amp_levels, harvest_from=harvest_from,
              overlap=overlap, tile_size=tile_size, teacher_tile=teacher_tile)
    if scene_chunk is not None and scene_chunk < n_scenes:
        if n_scenes % scene_chunk:
            raise ValueError(f"n_scenes={n_scenes} must be a multiple of "
                             f"scene_chunk={scene_chunk}")
        parts = [selffeed_cascade_dataset(model, variables, gen, scene_chunk, **kw)
                 for _ in range(n_scenes // scene_chunk)]
        return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}
    harvested = _harvested(cascade_resolutions(40, finest), harvest_from)
    k1, k2 = _wave_numbers(gen, n_scenes, k_range, dtype)
    theta_finest = _theta_fields(gen, n_scenes, finest, constant_theta, dtype)
    origins = sample_tile_origins(gen, n_scenes, harvested, tiles_per_level, tile_size)
    return selffeed_from_params(model, variables, k1, k2, theta_finest, origins, stats_mode,
                                refine_iters, amp_levels, harvest_from, overlap, tile_size,
                                teacher_tile)
