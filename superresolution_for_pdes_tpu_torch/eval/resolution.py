"""Resolution sweep: one scene, every target resolution, every method (port
of ``eval/resolution.py``).

Ground truth at 40/80/160/320/640; the ML cascade (``ml_multi_level``) and,
with ``refine_cycles > 0``, the same cascade with that many V-cycles of the
known PDE per level (``ml_physics``, whose finest level runs the stencil
kernels on a card at n >= 160) against direct and 2x-stepped bilinear and
bicubic interpolation of the 40^2 solve; per-resolution metrics in
``resolution_metrics.json``, and the log-log metric chart, error
distributions and comparison panels where matplotlib is installed. Not
ported: the tile axis split across devices (``tile_sharding``), which waits
for the multi-GPU slice.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from superresolution_for_pdes_tpu_torch.cascade.multires import solve_multi_resolution
from superresolution_for_pdes_tpu_torch.cascade.upscale import (
    interpolation_upscale,
    ml_cascade,
    multi_level_interpolation_upscale,
)
from superresolution_for_pdes_tpu_torch.eval.metrics import compute_metrics


def calibrate(model, variables, amp_calibrate: int, target_resolution: int, amp_k, amp_seed,
              amp_mode: str, amp_kind: str, amp_bpo: int, device, **cascade):
    """The eval harnesses' calibration: one amplitude per level
    (``amp_mode="scalar"``) or modal band gains (``"modal"``), fit on
    ``amp_calibrate`` self-generated scenes (never the evaluated ones)."""
    from superresolution_for_pdes_tpu_torch.cascade.modal import calibrate_modal
    from superresolution_for_pdes_tpu_torch.cascade.upscale import calibrate_amplitude

    if amp_mode == "modal":
        return calibrate_modal(model, variables, amp_seed, n_scenes=amp_calibrate,
                               target_resolution=target_resolution, k_range=amp_k,
                               kind=amp_kind, bands_per_octave=amp_bpo, device=device,
                               **cascade)
    return calibrate_amplitude(model, variables, amp_seed, n_scenes=amp_calibrate,
                               target_resolution=target_resolution, k_range=amp_k,
                               device=device, **cascade)


def gains_as_json(amp_levels):
    """Per-level gains as JSON values: a float for a scalar, nested lists else."""
    if amp_levels is None:
        return None
    arrays = [_np(a) for a in amp_levels]
    return [float(a) if a.ndim == 0 else a.tolist() for a in arrays]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_resolution_sweep(
    model,
    variables,
    seed_or_generator=0,
    resolutions: Sequence[int] = (80, 160, 320, 640),
    k_range: Tuple[float, float] = (10.0, 11.0),
    stats_mode: str = "oracle",
    save_dir: Optional[Path] = None,
    scene: Optional[Dict] = None,
    overlap=False,
    train_stats=None,
    symmetrize: bool = False,
    refine_cycles: int = 0,
    amp_calibrate: int = 0,
    amp_k: Tuple[float, float] = (6.0, 12.0),
    amp_seed: int = 100,
    amp_mode: str = "scalar",
    amp_kind: str = "radial",
    amp_bpo: int = 4,
    amp_levels=None,
    coarse_tile=20,
    device=None,
) -> Dict:
    """One scene, every target resolution, every method. Returns ``{metrics,
    solutions, scene, k1, k2, stats_mode, amp_levels}``.

    ``scene`` (``{k1, k2, u, f, theta}`` by resolution, one scene) is drawn
    from ``seed_or_generator`` on ``device`` (default ``cuda``; raises without
    a card) when not given; a given scene's tensors must be where the weights
    are. With ``amp_calibrate > 0`` and no ``amp_levels``, gains are fit first
    on self-generated scenes (``amp_mode``, ``amp_kind``, ``amp_bpo``,
    ``amp_k``, ``amp_seed``)."""
    resolutions = tuple(resolutions)
    if scene is None:
        scene = solve_multi_resolution(seed_or_generator, resolutions=resolutions,
                                       k_range=k_range, device=device)
    device = scene["u"][40].device
    cascade = dict(stats_mode=stats_mode, train_stats=train_stats, overlap=overlap,
                   symmetrize=symmetrize, coarse_tile=coarse_tile)
    if amp_levels is None and amp_calibrate > 0:
        amp_levels = calibrate(model, variables, amp_calibrate, max(resolutions), amp_k,
                               amp_seed, amp_mode, amp_kind, amp_bpo, device, **cascade)

    methods = {"ml_multi_level": ml_cascade(model, variables, scene, max(resolutions),
                                            amp_levels=amp_levels, **cascade)}
    if refine_cycles > 0:
        methods["ml_physics"] = ml_cascade(model, variables, scene, max(resolutions),
                                           refine_cycles=refine_cycles,
                                           amp_levels=amp_levels, **cascade)
    u40 = scene["u"][40]
    for res in resolutions:
        methods.setdefault("bilinear_direct", {})[res] = interpolation_upscale(u40, res, "bilinear")
        methods.setdefault("bicubic_direct", {})[res] = interpolation_upscale(u40, res, "bicubic")
        methods.setdefault("bilinear_multi_level", {})[res] = \
            multi_level_interpolation_upscale(u40, res, "bilinear")
        methods.setdefault("bicubic_multi_level", {})[res] = \
            multi_level_interpolation_upscale(u40, res, "bicubic")

    metrics: Dict[str, Dict[int, Dict[str, float]]] = {
        name: {res: {k: float(v) for k, v in compute_metrics(sol, scene["u"][res]).items()}
               for res, sol in by_res.items()}
        for name, by_res in methods.items()}
    k1, k2 = float(scene["k1"]), float(scene["k2"])
    result = {"metrics": metrics, "solutions": methods, "scene": scene, "k1": k1, "k2": k2,
              "stats_mode": stats_mode, "amp_levels": gains_as_json(amp_levels)}
    if save_dir is not None:
        _write(result, resolutions, Path(save_dir))
    return result


def _write(result: Dict, resolutions: Sequence[int], save_dir: Path) -> None:
    from superresolution_for_pdes_tpu_torch.eval import plots

    save_dir.mkdir(parents=True, exist_ok=True)
    metrics, methods, scene = result["metrics"], result["solutions"], result["scene"]
    (save_dir / "resolution_metrics.json").write_text(json.dumps(
        {key: result[key] for key in ("k1", "k2", "stats_mode", "amp_levels", "metrics")},
        indent=2))
    jobs = [(save_dir / "resolution_comparison_metrics.png", plots.resolution_metrics,
             dict(resolutions=list(resolutions),
                  metrics={name: {r: m["mae"] for r, m in by_res.items()}
                           for name, by_res in metrics.items()}))]
    for res in resolutions:
        truth = _np(scene["u"][res])
        ml, bl = _np(methods["ml_multi_level"][res]), _np(methods["bilinear_direct"][res])
        jobs.append((save_dir / f"error_distribution_{res}x{res}.png", plots.error_distribution,
                     dict(errors={"ML multi-level": np.abs(ml - truth),
                                  "Bilinear direct": np.abs(bl - truth)},
                          title=f"Error distribution at {res}x{res}")))
        jobs.append((save_dir / f"comparison_enhanced_{res}x{res}.png", plots.sample_comparison,
                     dict(coarse=_np(scene["u"][40]), truth=truth, ml=ml, bilinear=bl,
                          theta=_np(scene["theta"][res]), forcing=_np(scene["f"][res]),
                          k1=result["k1"], k2=result["k2"])))
    plots.draw_figures(jobs)
