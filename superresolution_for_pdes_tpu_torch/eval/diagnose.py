"""Per-scene failure diagnosis for the statistical cascade benchmark (port
of ``eval/diagnose.py``; numpy only, no model).

Turns a ``statistical_results.json`` (written by
``eval.statistical.run_statistical_benchmark``) into a ranked feature table:
for every scene, model-free structural features from (k1, k2) and the
recorded truth amplitudes, each rank-correlated (Spearman) with the scene's ML
relative L2 at every resolution.

Features:

* ``amp_ratio`` -- truth_rms(res) / rms(u_40): the exact solution's amplitude
  decay, which the cascade has to learn;
* ``tile_misalign_L{l}`` -- distance from an integer of the forcing's phase
  advance between adjacent tiles of cascade level ``l`` (``stride * k /
  (R - 1)`` cycles on the level's input grid ``linspace(0, 1, R)``; 0 = every
  tile sees the same phase, 0.5 = maximal staggering), max over both axes;
* ``k_frac`` -- distance of k from the nearest integer (spectral leakage),
  max over axes;
* ``k_sum`` / ``k_min`` / ``k_max`` -- raw wavenumbers, the null reference;
* ``bilinear_rel_l2`` -- the scene's difficulty for the baseline.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


def _dist_to_int(x: np.ndarray) -> np.ndarray:
    """Distance to the nearest integer, in [0, 0.5]."""
    return np.abs(x - np.round(x))


def scene_features(k1: float, k2: float, levels: Sequence[int] = (40, 80, 160, 320),
                   stride: float = 20.0) -> Dict[str, float]:
    """Model-free structural features of one scene.

    ``levels`` lists the *input* resolutions of the cascade levels
    (40->80 is level 1 with input 40, ...).  ``stride`` is the tile-to-tile
    advance in input-grid points: 20 for the non-overlap cascade, 10 for
    overlap-feathered levels (``cascade/upscale.py`` uses
    ``c_stride = coarse_tile // 2``); pass the stride matching the run being
    diagnosed or the ``tile_misalign`` feature mischaracterizes the phase
    staggering.
    """
    k = np.array([k1, k2], dtype=np.float64)
    feats: Dict[str, float] = {
        "k_sum": float(k.sum()),
        "k_min": float(k.min()),
        "k_max": float(k.max()),
        "k_frac": float(_dist_to_int(k).max()),
    }
    for lvl, r_in in enumerate(levels, start=1):
        # Phase advance between adjacent tiles of the input grid (stride
        # points apart), in cycles of the forcing sin(2*pi*k*x),
        # x = linspace(0, 1, R).
        adv = stride * k / (r_in - 1)
        feats[f"tile_misalign_L{lvl}"] = float(_dist_to_int(adv).max())
    return feats


def _spearman(x: np.ndarray, y: np.ndarray) -> float:
    """Spearman rank correlation (numpy-only; average ranks for ties)."""
    def rank(v: np.ndarray) -> np.ndarray:
        order = np.argsort(v, kind="stable")
        r = np.empty_like(order, dtype=np.float64)
        r[order] = np.arange(len(v), dtype=np.float64)
        # average tied ranks
        for val in np.unique(v):
            m = v == val
            if m.sum() > 1:
                r[m] = r[m].mean()
        return r
    rx, ry = rank(x), rank(y)
    rx -= rx.mean(); ry -= ry.mean()
    denom = np.sqrt((rx**2).sum() * (ry**2).sum())
    return float((rx * ry).sum() / denom) if denom > 0 else 0.0


def diagnose(result: Dict, focus: Optional[int] = None, stride: float = 20.0) -> Dict:
    """Feature/correlation table from a ``run_statistical_benchmark`` result.

    Returns ``{"resolutions": [...], "features": {name: {res: spearman}},
    "table": [per-scene dict], "worst": {res: [scene indices, worst first]}}``.
    ``stride`` parameterizes the ``tile_misalign`` features (see
    :func:`scene_features`; use 10 when diagnosing an overlap-feathered run).
    """
    records = result["records"]
    # JSON round-trip stringifies the integer resolution keys.
    def res_entry(r, res):
        return r[res] if res in r else r[str(res)]

    resolutions = sorted(
        int(kk) for kk in records[0] if str(kk).isdigit() or isinstance(kk, int)
    )
    levels = [r for r in (40, 80, 160, 320) if r < max(resolutions)]

    table = []
    for i, r in enumerate(records):
        row = {"scene": i, "k1": r["k1"], "k2": r["k2"],
               **scene_features(r["k1"], r["k2"], levels, stride=stride)}
        rms40 = r.get("rms40")
        for res in resolutions:
            e = res_entry(r, res)
            row[f"ml_rel_l2_{res}"] = e["ml"]["relative_l2"]
            row[f"bl_rel_l2_{res}"] = e["bilinear"]["relative_l2"]
            # NaN (not a missing key) when the record lacks the amplitude
            # data, so mixed old/new records still build a rectangular table.
            if (rms40 is not None and rms40 != 0.0
                    and e.get("truth_rms") is not None):
                row[f"amp_ratio_{res}"] = e["truth_rms"] / rms40
            else:
                row[f"amp_ratio_{res}"] = float("nan")
        table.append(row)

    def _masked_spearman(x: np.ndarray, y: np.ndarray) -> float:
        m = np.isfinite(x) & np.isfinite(y)
        return _spearman(x[m], y[m]) if m.sum() >= 3 else float("nan")

    feature_names = [k for k in table[0]
                     if not k.startswith(("ml_rel_l2", "bl_rel_l2", "amp_ratio"))
                     and k not in ("scene",)]
    correlations: Dict[str, Dict[int, float]] = {}
    for res in resolutions:
        y = np.array([row[f"ml_rel_l2_{res}"] for row in table])
        for name in feature_names:
            x = np.array([row[name] for row in table])
            correlations.setdefault(name, {})[res] = _masked_spearman(x, y)
        x = np.array([row[f"amp_ratio_{res}"] for row in table])
        if np.isfinite(x).sum() >= 3:
            correlations.setdefault("amp_ratio", {})[res] = _masked_spearman(x, y)
        x = np.array([row[f"bl_rel_l2_{res}"] for row in table])
        correlations.setdefault("bilinear_rel_l2", {})[res] = _masked_spearman(x, y)

    worst = {res: [int(i) for i in np.argsort(
        [-row[f"ml_rel_l2_{res}"] for row in table], kind="stable")]
        for res in resolutions}
    out = {"resolutions": resolutions, "features": correlations,
           "table": table, "worst": worst}
    if focus is not None:
        out["focus"] = focus
    return out


def format_report(diag: Dict, focus: Optional[int] = None, top: int = 5) -> str:
    """Human-readable correlation table + worst-scene listing."""
    resolutions = diag["resolutions"]
    if focus is not None and focus not in resolutions:
        raise ValueError(
            f"--focus {focus} is not a resolution of this run; "
            f"valid resolutions: {resolutions}")
    lines = ["Spearman(feature, ML rel-L2) per resolution:", ""]
    header = f"{'feature':<20}" + "".join(f"{res:>9}" for res in resolutions)
    lines.append(header)
    for name, per_res in sorted(
            diag["features"].items(),
            key=lambda kv: -max((abs(v) for v in kv[1].values()
                                 if v is not None and np.isfinite(v)),
                                default=0.0)):
        lines.append(f"{name:<20}" + "".join(
            f"{per_res.get(res, float('nan')):>9.2f}" for res in resolutions))
    for res in ([focus] if focus else resolutions):
        lines.append("")
        lines.append(f"worst scenes @ {res}^2 (ml rel-L2 / bilinear rel-L2 / k1,k2):")
        for i in diag["worst"][res][:top]:
            row = diag["table"][i]
            lines.append(
                f"  scene {i:>3}: {row[f'ml_rel_l2_{res}']:.3f} / "
                f"{row[f'bl_rel_l2_{res}']:.3f} / k=({row['k1']:.2f},{row['k2']:.2f})"
                + (f" amp_ratio={row[f'amp_ratio_{res}']:.2f}"
                   if np.isfinite(row.get(f"amp_ratio_{res}", float("nan")))
                   else ""))
    return "\n".join(lines)


def diagnose_file(path: str | Path, focus: Optional[int] = None,
                  stride: float = 20.0) -> Dict:
    return diagnose(json.loads(Path(path).read_text()), focus=focus,
                    stride=stride)
