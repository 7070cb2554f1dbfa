"""Out-of-sample evaluation on fresh high-frequency data (port of
``eval/out_of_sample.py``).

A fresh test set with k outside the training range (default U(5, 8)) goes
through the single-level comparison (:func:`~.single_level.evaluate_dataset`,
label ``out_of_sample``); with ``save_dir`` it writes
``average_metrics.json`` (``avg_<method>_<metric>``) and, where matplotlib is
installed, each plotted sample's error distribution and mid-row
cross-section.

The draw (:func:`evaluate_out_of_sample`, from a seed or a
``torch.Generator``) is split from the deterministic step
(:func:`out_of_sample_on_data`), so a set drawn elsewhere (the JAX
package's) can be fed in: a seed does not give the JAX package's samples.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from superresolution_for_pdes_tpu_torch.data.generate import generate_test_dataset
from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
from superresolution_for_pdes_tpu_torch.eval.single_level import evaluate_dataset, predict_ml
from superresolution_for_pdes_tpu_torch.ops.resize import resize_align_corners


def out_of_sample_on_data(model, variables, data: Dict, save_dir: Optional[Path] = None,
                          n_plot: int = 3, normalization: str = "dataset",
                          symmetrize: bool = False) -> Dict:
    """The deterministic step: :func:`evaluate_dataset` on ``data`` and, with
    ``save_dir``, the averages and the per-sample figures. ``model`` is a
    module with ``variables``, or a router (``variables`` None)."""
    result = evaluate_dataset(model, variables, data, label="out_of_sample", save_dir=save_dir,
                              n_plot=n_plot, normalization=normalization, symmetrize=symmetrize)
    if save_dir is None:
        return result
    from superresolution_for_pdes_tpu_torch.eval import plots

    save_dir = Path(save_dir)
    avg = {f"avg_{method}_{metric}": value
           for method, ms in result["summary"].items() for metric, value in ms.items()}
    (save_dir / "average_metrics.json").write_text(json.dumps(avg, indent=2))

    n = min(n_plot, int(data["u_fine"].shape[0]))
    ml = predict_ml(model, variables, data, NormStats.from_dataset(data), normalization,
                    symmetrize)[:n].cpu().numpy()
    fine_shape = tuple(int(s) for s in data["u_fine"].shape[-2:])
    bilinear = resize_align_corners(data["u_coarse"][:n], fine_shape, "bilinear").cpu().numpy()
    truth = data["u_fine"][:n].cpu().numpy()
    jobs = []
    for i in range(n):
        jobs.append((save_dir / f"error_distribution_{i + 1}.png", plots.error_distribution,
                     dict(errors={"ML": np.abs(ml[i] - truth[i]),
                                  "Bilinear": np.abs(bilinear[i] - truth[i])},
                          title=f"Out-of-sample error distribution (sample {i + 1})")))
        jobs.append((save_dir / f"cross_section_{i + 1}.png", plots.cross_section,
                     dict(fields={"Ground truth": truth[i], "ML": ml[i], "Bilinear": bilinear[i]},
                          row=truth.shape[1] // 2,
                          title=f"Mid-row cross-section (sample {i + 1})")))
    plots.draw_figures(jobs)
    return result


def evaluate_out_of_sample(model, variables, seed_or_generator=0, n_samples: int = 5,
                           k_range: Tuple[float, float] = (5.0, 8.0),
                           save_dir: Optional[Path] = None, n_plot: int = 3,
                           constant_theta: bool = True, normalization: str = "dataset",
                           symmetrize: bool = False, device=None) -> Dict:
    """``n_samples`` fresh samples, k ~ U(``k_range``), theta == 1 or (with
    ``constant_theta=False``) U(0.5, 2), drawn on ``device`` (default
    ``cuda``; raises without a card), then :func:`out_of_sample_on_data`."""
    data = generate_test_dataset(seed_or_generator, n_samples, k_range,
                                 constant_theta=constant_theta, device=device)
    return out_of_sample_on_data(model, variables, data, save_dir, n_plot, normalization,
                                 symmetrize)
