"""Single-level (20 -> 40) evaluation: ML against interpolation (port of
``eval/single_level.py``).

The whole test set is one model batch. The bilinear and bicubic baselines
interpolate the physical coarse solution (align corners). ML predictions are
denormalized with the evaluated set's own statistics, as the reference builds
one dataset per test set.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from superresolution_for_pdes_tpu_torch.cascade.upscale import apply_model, dihedral_apply
from superresolution_for_pdes_tpu_torch.data.normalization import (
    NormStats,
    make_model_inputs,
    per_sample_stats,
)
from superresolution_for_pdes_tpu_torch.eval.metrics import compute_metrics
from superresolution_for_pdes_tpu_torch.ops.resize import resize_align_corners


def predict_dataset(model, variables, data: Dict, stats: Optional[NormStats] = None,
                    normalization: str = "dataset", symmetrize: bool = False) -> torch.Tensor:
    """Denormalized ML predictions ``(B, 40, 40)`` for every sample of a
    dataset dict, in eval mode. ``normalization="per_sample"`` normalizes each
    sample by its own coarse input, forcing and coefficient (models trained
    with per-sample normalization); ``symmetrize`` averages the model over the
    square's 8 symmetries. ``variables`` as for the cascade: None, a
    state_dict or a module."""
    if normalization == "per_sample":
        stats = per_sample_stats(data["u_coarse"], data["f_fine"], data["theta_fine"])
    elif stats is None:
        stats = NormStats.from_dataset(data)
    x = make_model_inputs(data["u_coarse"], data["f_fine"], data["theta_fine"], stats,
                          scale_channels=getattr(model, "in_channels", 3) > 3)
    model.eval()
    if isinstance(variables, nn.Module):
        variables.eval()
    with torch.no_grad():
        pred = (dihedral_apply if symmetrize else apply_model)(model, variables, x)
    return stats.denormalize_u(pred[:, 0])


def predict_ml(model, variables, data: Dict, stats: NormStats, normalization: str = "dataset",
               symmetrize: bool = False) -> torch.Tensor:
    """ML predictions as :func:`evaluate_dataset` scores them: a ``model``
    with a ``predict(data, stats, symmetrize=...)`` method (an expert
    ensemble) predicts for itself, any other goes through
    :func:`predict_dataset`."""
    if hasattr(model, "predict"):
        return model.predict(data, stats, symmetrize=symmetrize)
    return predict_dataset(model, variables, data, stats, normalization=normalization,
                           symmetrize=symmetrize)


def evaluate_dataset(model, variables, data: Dict, label: str = "test",
                     save_dir: Optional[Path] = None, stats: Optional[NormStats] = None,
                     n_plot: int = 3, space: str = "physical", normalization: str = "dataset",
                     symmetrize: bool = False) -> Dict:
    """Per-sample and mean MAE, RMSE, max error and relative L2 of ML,
    bilinear and bicubic at 40^2. ``space="physical"`` compares denormalized
    fields; ``"normalized"`` scores in the set's normalized space (the
    reference visualizer's choice). A ``model`` with a ``predict(data, stats,
    symmetrize=...)`` method (an expert ensemble) predicts for itself. With
    ``save_dir``, writes ``<label>_metrics.json`` and, where matplotlib is
    installed, ``n_plot`` sample figures."""
    if stats is None:
        stats = NormStats.from_dataset(data)
    target = data["u_fine"]
    fine_shape = tuple(int(s) for s in target.shape[-2:])
    ml = predict_ml(model, variables, data, stats, normalization, symmetrize)
    bilinear = resize_align_corners(data["u_coarse"], fine_shape, "bilinear")
    bicubic = resize_align_corners(data["u_coarse"], fine_shape, "bicubic")
    if space == "normalized":
        target, ml, bilinear, bicubic = (stats.normalize_u(x)
                                         for x in (target, ml, bilinear, bicubic))
    elif space != "physical":
        raise ValueError(f"unknown metric space: {space!r}")

    per_sample = {
        method: {k: v.cpu().numpy() for k, v in compute_metrics(pred, target).items()}
        for method, pred in (("ml", ml), ("bilinear", bilinear), ("bicubic", bicubic))
    }
    result = {
        "label": label,
        "n_samples": int(target.shape[0]),
        "k1": data["k1"].tolist(),
        "k2": data["k2"].tolist(),
        "per_sample": per_sample,
        "summary": {method: {k: float(v.mean()) for k, v in ms.items()}
                    for method, ms in per_sample.items()},
    }
    if save_dir is not None:
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        _write_artifacts(result, data, ml, bilinear, save_dir, label, n_plot)
    return result


def _write_artifacts(result: Dict, data: Dict, ml: torch.Tensor, bilinear: torch.Tensor,
                     save_dir: Path, label: str, n_plot: int) -> None:
    from superresolution_for_pdes_tpu_torch.eval import plots

    serializable = {
        **{k: result[k] for k in ("label", "n_samples", "k1", "k2", "summary")},
        "per_sample": {m: {k: v.tolist() for k, v in ms.items()}
                       for m, ms in result["per_sample"].items()},
    }
    (save_dir / f"{label}_metrics.json").write_text(json.dumps(serializable, indent=2))

    def host(x, i):
        return np.asarray(x[i].detach().cpu())

    plots.draw_figures([
        (save_dir / f"{label}_sample_{i + 1}.png", plots.sample_comparison,
         dict(coarse=host(data["u_coarse"], i), truth=host(data["u_fine"], i),
              ml=host(ml, i), bilinear=host(bilinear, i), theta=host(data["theta_fine"], i),
              forcing=host(data["f_fine"], i), k1=float(data["k1"][i]),
              k2=float(data["k2"][i])))
        for i in range(min(n_plot, int(data["u_fine"].shape[0])))])
