"""Statistical benchmark: N independent scenes with accuracy and wall-clock
statistics (port of ``eval/statistical.py``).

The N scenes (k ~ U(8, 12) by default) are solved exactly, batched, at every
resolution; all of them go through ONE cascade pass (in chunks of scenes per
model call, as the cascade chooses), run level by level
(:func:`~superresolution_for_pdes_tpu_torch.cascade.upscale.ml_cascade_stepwise`),
so the time to reach a target is the cumulative sum of its level times
divided by N. Per-example MAE, RMSE and relative L2 of the cascade and of
bilinear interpolation at every resolution, with the direct solve's,
cascade's and interpolation's times, are aggregated into
``statistical_results.json``, ``statistical_results.csv`` (stdlib ``csv``)
and ``summary.txt``; box plots, mean +/- std bands, the error against
k1 + k2 and the timing figure are drawn where matplotlib is installed.

Each wall time ends in a device synchronisation. Before the timed pass,
:func:`~superresolution_for_pdes_tpu_torch.cascade.upscale.warmup_cascade_stepwise`
runs every level once on the first scene. Not ported: ``run_single_example``
(the batched harness replaces it).
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from superresolution_for_pdes_tpu_torch.cascade.multires import solve_multi_resolution_batch
from superresolution_for_pdes_tpu_torch.cascade.upscale import (
    interpolation_upscale,
    level_resolutions,
    ml_cascade_stepwise,
    warmup_cascade_stepwise,
)
from superresolution_for_pdes_tpu_torch.eval.metrics import compute_metrics
from superresolution_for_pdes_tpu_torch.eval.resolution import calibrate, gains_as_json
from superresolution_for_pdes_tpu_torch.solver.dst import solve_poisson_dst

CSV_COLUMNS = ("example", "resolution", "k1", "k2", "ml_mae", "ml_rmse", "ml_rel_l2",
               "bilinear_mae", "bilinear_rmse", "bilinear_rel_l2", "truth_rms", "rms40",
               "ml_time", "bilinear_time", "solve_time")


def _timed(fn, device: torch.device) -> Tuple[object, float]:
    """``fn()`` and its wall seconds, after one untimed call, each ending in a
    device synchronisation."""
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def solve_times(scenes: Dict, refine_iters: int = 1) -> Dict[int, float]:
    """Wall seconds per scene of the batched exact solve at each resolution
    (a warm call, then a timed one)."""
    times = {}
    for res, f in scenes["f"].items():
        _, seconds = _timed(lambda: solve_poisson_dst(f, scenes["theta"][res], refine_iters),
                            f.device)
        times[res] = seconds / f.shape[0]
    return times


def statistics_on_scenes(model, variables, scenes: Dict, resolutions: Sequence[int],
                         solve_seconds: Dict[int, float], stats_mode: str = "oracle",
                         train_stats=None, overlap=False, symmetrize: bool = False,
                         refine_cycles: int = 0, amp_levels=None,
                         coarse_tile=20, scene_chunk=None) -> Tuple[list, Dict]:
    """The scene-consuming part of :func:`run_statistical_benchmark`:
    ``(records, aggregate)`` for ``scenes`` (``{k1, k2, u, f, theta}`` with a
    leading scene axis) and the solve times per resolution; ``scene_chunk`` is
    the cascade's scenes per model call (default: its own)."""
    resolutions = tuple(resolutions)
    n = scenes["u"][40].shape[0]
    device = scenes["u"][40].device
    top = max(resolutions)
    cascade = dict(stats_mode=stats_mode, train_stats=train_stats, overlap=overlap,
                   symmetrize=symmetrize, refine_cycles=refine_cycles, amp_levels=amp_levels,
                   coarse_tile=coarse_tile, scene_chunk=scene_chunk)
    warmup_cascade_stepwise(model, variables, scenes, top, **cascade)
    ml_fields, level_times = ml_cascade_stepwise(model, variables, scenes, top, **cascade)
    ml_times, cum = {}, 0.0
    for res in level_resolutions(40, top):
        cum += level_times[res]
        if res in resolutions:
            ml_times[res] = cum / n

    bl_fields, bl_times = {}, {}
    for res in resolutions:
        bl_fields[res], seconds = _timed(
            lambda res=res: interpolation_upscale(scenes["u"][40], res, "bilinear"), device)
        bl_times[res] = seconds / n

    def per_example(metrics):
        return [{k: float(v[i]) for k, v in metrics.items()} for i in range(n)]

    def rms(x):
        return torch.sqrt(torch.mean(x ** 2, dim=(-2, -1))).tolist()

    k1, k2 = torch.as_tensor(scenes["k1"]).tolist(), torch.as_tensor(scenes["k2"]).tolist()
    rms40 = rms(scenes["u"][40])
    records = [{"k1": k1[i], "k2": k2[i], "rms40": rms40[i], "solve_times": dict(solve_seconds)}
               for i in range(n)]
    for res in resolutions:
        truth = scenes["u"][res]
        ml = per_example(compute_metrics(ml_fields[res], truth))
        bl = per_example(compute_metrics(bl_fields[res], truth))
        truth_rms = rms(truth)
        for i, record in enumerate(records):
            record[res] = {"ml": ml[i], "bilinear": bl[i], "truth_rms": truth_rms[i],
                           "ml_time": ml_times[res], "bilinear_time": bl_times[res]}

    aggregate: Dict = {}
    for res in resolutions:
        ml_mae = np.array([r[res]["ml"]["mae"] for r in records])
        bl_mae = np.array([r[res]["bilinear"]["mae"] for r in records])
        ml_rl2 = np.array([r[res]["ml"]["relative_l2"] for r in records])
        bl_rl2 = np.array([r[res]["bilinear"]["relative_l2"] for r in records])
        aggregate[res] = {
            "ml_mae_mean": float(ml_mae.mean()), "ml_mae_std": float(ml_mae.std()),
            "bilinear_mae_mean": float(bl_mae.mean()), "bilinear_mae_std": float(bl_mae.std()),
            "ml_advantage": float(bl_mae.mean() / max(ml_mae.mean(), 1e-30)),
            "ml_rel_l2_mean": float(ml_rl2.mean()), "ml_rel_l2_std": float(ml_rl2.std()),
            "bilinear_rel_l2_mean": float(bl_rl2.mean()),
            "ml_time_mean": ml_times[res],
            "bilinear_time_mean": bl_times[res],
            "solve_time_mean": float(solve_seconds.get(res, np.nan)),
        }
    return records, aggregate


def run_statistical_benchmark(
    model,
    variables,
    seed_or_generator=0,
    n_examples: int = 10,
    resolutions: Sequence[int] = (80, 160, 320, 640),
    k_range: Tuple[float, float] = (8.0, 12.0),
    stats_mode: str = "oracle",
    save_dir: Optional[Path] = None,
    train_stats=None,
    overlap=False,
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
    theta_range: Tuple[float, float] = (0.5, 2.0),
    device=None,
) -> Dict:
    """``n_examples`` scenes drawn from ``seed_or_generator`` and solved on
    ``device`` (default ``cuda``; raises without a card), through the cascade
    and bilinear interpolation. Returns ``{records, aggregate, n_examples,
    k_range, stats_mode, refine_cycles, amp_levels}`` and, with ``save_dir``,
    writes the JSON, CSV, summary and figures there. With ``amp_calibrate > 0``
    and no ``amp_levels``, gains are fit first on self-generated scenes."""
    resolutions = tuple(resolutions)
    cascade = dict(stats_mode=stats_mode, train_stats=train_stats, overlap=overlap,
                   symmetrize=symmetrize, coarse_tile=coarse_tile)
    # the full doubling ladder: the cascade needs f and theta at every level
    scenes = solve_multi_resolution_batch(
        seed_or_generator, n_examples, resolutions=level_resolutions(40, max(resolutions)),
        k_range=k_range, theta_range=theta_range, device=device)
    if amp_levels is None and amp_calibrate > 0:
        amp_levels = calibrate(model, variables, amp_calibrate, max(resolutions), amp_k,
                               amp_seed, amp_mode, amp_kind, amp_bpo, scenes["u"][40].device,
                               theta_range=theta_range, **cascade)
    records, aggregate = statistics_on_scenes(
        model, variables, scenes, resolutions, solve_times(scenes),
        refine_cycles=refine_cycles, amp_levels=amp_levels, **cascade)
    result = {"records": records, "aggregate": aggregate, "n_examples": n_examples,
              "k_range": list(k_range), "stats_mode": stats_mode,
              "refine_cycles": refine_cycles, "amp_levels": gains_as_json(amp_levels)}
    if save_dir is not None:
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        (save_dir / "statistical_results.json").write_text(json.dumps(
            {k: v for k, v in result.items() if k != "records"}
            | {"records": [{str(kk): vv for kk, vv in r.items()} for r in records]},
            indent=2, default=float))
        write_csv_summary_and_plots(records, aggregate, resolutions, save_dir)
    return result


def write_csv_summary_and_plots(records, aggregate, resolutions, save_dir: Path) -> None:
    """``statistical_results.csv`` (one row per example and resolution),
    ``summary.txt`` and, where matplotlib is installed, the figures."""
    from superresolution_for_pdes_tpu_torch.eval import plots

    with open(save_dir / "statistical_results.csv", "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(CSV_COLUMNS)
        for i, r in enumerate(records):
            for res in resolutions:
                ml, bl = r[res]["ml"], r[res]["bilinear"]
                writer.writerow([
                    i, res, r["k1"], r["k2"], ml["mae"], ml["rmse"], ml["relative_l2"],
                    bl["mae"], bl["rmse"], bl["relative_l2"], r[res]["truth_rms"], r["rms40"],
                    r[res]["ml_time"], r[res]["bilinear_time"],
                    r["solve_times"].get(res, float("nan"))])

    lines = ["Statistical benchmark summary", "=" * 34]
    for res in resolutions:
        a = aggregate[res]
        lines += [
            f"{res}x{res}: ML MAE {a['ml_mae_mean']:.3e} +/- {a['ml_mae_std']:.1e} | "
            f"bilinear MAE {a['bilinear_mae_mean']:.3e} +/- {a['bilinear_mae_std']:.1e} | "
            f"advantage {a['ml_advantage']:.1f}x",
            f"    rel-L2: ml {a['ml_rel_l2_mean']:.3f} +/- {a['ml_rel_l2_std']:.3f}, "
            f"bilinear {a['bilinear_rel_l2_mean']:.3f}",
            f"    times: ml {a['ml_time_mean']*1e3:.2f} ms, bilinear "
            f"{a['bilinear_time_mean']*1e3:.2f} ms, direct solve "
            f"{a['solve_time_mean']*1e3:.2f} ms",
        ]
    (save_dir / "summary.txt").write_text("\n".join(lines) + "\n")

    def maes(res, method):
        return np.array([r[res][method]["mae"] for r in records])

    top = max(resolutions)
    jobs = [(save_dir / f"mae_box_{res}x{res}.png", plots.box,
             dict(series={"ML": maes(res, "ml"), "Bilinear": maes(res, "bilinear")},
                  ylabel=f"MAE at {res}x{res}", log=True)) for res in resolutions]
    jobs += [
        (save_dir / "mae_mean_std_bands.png", plots.mean_std_bands,
         dict(resolutions=resolutions, ylabel="MAE", series={
             "ML": ([aggregate[r]["ml_mae_mean"] for r in resolutions],
                    [aggregate[r]["ml_mae_std"] for r in resolutions]),
             "Bilinear": ([aggregate[r]["bilinear_mae_mean"] for r in resolutions],
                          [aggregate[r]["bilinear_mae_std"] for r in resolutions])})),
        (save_dir / "mae_vs_wavenumber.png", plots.scatter_vs_k,
         dict(k_sum=np.array([r["k1"] + r["k2"] for r in records]),
              series={"ML": maes(top, "ml"), "Bilinear": maes(top, "bilinear")},
              ylabel=f"MAE at {top}x{top}")),
        (save_dir / "computation_times.png", plots.computation_times,
         dict(resolutions=resolutions, times={
             "ML cascade": [aggregate[r]["ml_time_mean"] for r in resolutions],
             "Bilinear": [aggregate[r]["bilinear_time_mean"] for r in resolutions],
             "Direct solve": [aggregate[r]["solve_time_mean"] for r in resolutions]})),
    ]
    plots.draw_figures(jobs)
