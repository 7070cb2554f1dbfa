"""Generalization grid: in/out-of-sample x constant/varying theta (port of
``eval/test_cases.py``).

Five test sets (:data:`GRID`): "training-like" (k in the training range
0.5-5), in-sample k U(1, 6) and out-of-sample k U(6, 8), each with theta == 1
and with theta ~ U(0.5, 2), evaluated single-level; with ``save_dir``,
``comprehensive_test_results.json`` (each set's summary) and, where
matplotlib is installed, grouped bars of MAE and RMSE, linear and log.

The draw (:func:`grid_datasets`: the five sets in order from one generator)
is split from the deterministic step (:func:`generalization_grid_on_data`),
so sets drawn elsewhere (the JAX package's) can be fed in.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

from superresolution_for_pdes_tpu_torch.data.generate import generate_test_dataset, make_generator
from superresolution_for_pdes_tpu_torch.eval.single_level import evaluate_dataset

GRID = (
    ("training_like", (0.5, 5.0), True),
    ("in_sample_const_theta", (1.0, 6.0), True),
    ("in_sample_varying_theta", (1.0, 6.0), False),
    ("out_of_sample_const_theta", (6.0, 8.0), True),
    ("out_of_sample_varying_theta", (6.0, 8.0), False),
)


def grid_datasets(seed_or_generator=0, n_samples: int = 10, device=None) -> Dict[str, Dict]:
    """The :data:`GRID` sets of ``n_samples`` each, by label, drawn in order
    from one generator on ``device`` (default ``cuda``; raises without a
    card)."""
    gen = make_generator(seed_or_generator, device)
    return {label: generate_test_dataset(gen, n_samples, k_range, constant_theta=const_theta)
            for label, k_range, const_theta in GRID}


def generalization_grid_on_data(model, variables, datasets: Dict[str, Dict],
                                save_dir: Optional[Path] = None, n_plot: int = 2,
                                symmetrize: bool = False) -> Dict[str, Dict]:
    """The deterministic step: :func:`evaluate_dataset` on each labelled set
    (dataset normalization, or the router's own), then the JSON and
    figures."""
    results = {label: evaluate_dataset(model, variables, data, label=label, save_dir=save_dir,
                                       n_plot=n_plot, symmetrize=symmetrize)
               for label, data in datasets.items()}
    if save_dir is None:
        return results
    from superresolution_for_pdes_tpu_torch.eval import plots

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    (save_dir / "comprehensive_test_results.json").write_text(
        json.dumps({label: r["summary"] for label, r in results.items()}, indent=2))
    labels = list(results)
    jobs = []
    for metric in ("mae", "rmse"):
        series = {method: [results[label]["summary"][method][metric] for label in labels]
                  for method in ("ml", "bilinear", "bicubic")}
        for suffix, log in (("", False), ("_log", True)):
            jobs.append((save_dir / f"comparison_{metric}{suffix}.png", plots.grouped_bars,
                         dict(group_labels=labels, series=series, log=log,
                              ylabel=metric.upper() + (" (log)" if log else ""))))
    plots.draw_figures(jobs)
    return results


def run_generalization_grid(model, variables, seed_or_generator=0, n_samples: int = 10,
                            save_dir: Optional[Path] = None, n_plot: int = 2,
                            symmetrize: bool = False, device=None) -> Dict[str, Dict]:
    """:func:`grid_datasets`, then :func:`generalization_grid_on_data`."""
    return generalization_grid_on_data(model, variables,
                                       grid_datasets(seed_or_generator, n_samples, device),
                                       save_dir, n_plot, symmetrize)
