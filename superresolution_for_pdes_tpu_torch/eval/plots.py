"""The harnesses' figures (port of ``eval/plots.py``): numpy and matplotlib
with the Agg backend. Each figure is a function ``fn(plt, **kw) -> fig``.

Figures are drawn only where matplotlib imports; :func:`draw_figures` prints
one line naming the figures it skipped otherwise. No number the harnesses
report depends on a figure. The error distributions are histograms (the JAX
package draws a KDE where seaborn is installed).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


def draw_figures(jobs: Sequence[Tuple[Path, Callable, Dict]]) -> List[Path]:
    """Run each ``(path, plot function, keyword arguments)`` job and return
    the paths written, or print which figures were skipped and return ``[]``
    when matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        names = ", ".join(Path(path).name for path, _, _ in jobs)
        print(f"matplotlib is not installed: figures skipped: {names}")
        return []
    for path, fn, kwargs in jobs:
        fig = fn(plt, **kwargs)
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)
    return [Path(path) for path, _, _ in jobs]


def sample_comparison(plt, coarse, truth, ml, bilinear, theta, forcing, k1, k2):
    """Coarse input, truth, forcing, ML, bilinear, theta and the error panels
    of one scene at one resolution."""
    fig, axes = plt.subplots(3, 3, figsize=(15, 13))
    fig.suptitle(f"k1={k1:.2f}, k2={k2:.2f}")
    vmin = min(truth.min(), ml.min(), bilinear.min())
    vmax = max(truth.max(), ml.max(), bilinear.max())
    panels = [
        ("Coarse input", coarse, None),
        ("Ground truth", truth, (vmin, vmax)),
        ("Forcing f", forcing, None),
        ("ML prediction", ml, (vmin, vmax)),
        ("Bilinear", bilinear, (vmin, vmax)),
        ("theta", theta, None),
        ("ML |error|", np.abs(ml - truth), None),
        ("Bilinear |error|", np.abs(bilinear - truth), None),
        ("Error diff (ML - BL)", np.abs(ml - truth) - np.abs(bilinear - truth), None),
    ]
    for ax, (title, field, clim) in zip(axes.ravel(), panels):
        im = ax.imshow(field, cmap="RdBu_r" if "diff" in title else "viridis")
        if clim:
            im.set_clim(*clim)
        ax.set_title(title)
        ax.set_xticks([])
        ax.set_yticks([])
        fig.colorbar(im, ax=ax, fraction=0.046)
    return fig


def _log_resolution_axis(ax, resolutions, ylabel):
    ax.set_xscale("log", base=2)
    ax.set_xticks(list(resolutions), [f"{r}x{r}" for r in resolutions])
    ax.set_xlabel("Resolution")
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    ax.legend()


def resolution_metrics(plt, resolutions: Sequence[int], metrics: Dict[str, Dict[int, float]]):
    """Log-log MAE against resolution, one line per method."""
    fig, ax = plt.subplots(figsize=(10, 7))
    for method, by_res in metrics.items():
        ax.plot(resolutions, [by_res[r] for r in resolutions], "o-", label=method)
    ax.set_yscale("log")
    _log_resolution_axis(ax, resolutions, "MAE")
    return fig


def error_distribution(plt, errors: Dict[str, np.ndarray], title: str):
    """Histograms of absolute errors."""
    fig, ax = plt.subplots(figsize=(10, 7))
    for label, err in errors.items():
        ax.hist(err.ravel(), bins=100, alpha=0.5, label=label, density=True)
    ax.set_xlabel("Absolute error")
    ax.set_ylabel("Density")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    return fig


def box(plt, series: Dict[str, np.ndarray], ylabel: str, log: bool = False):
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.boxplot(list(series.values()), tick_labels=list(series.keys()))
    ax.set_ylabel(ylabel)
    if log:
        ax.set_yscale("log")
    ax.grid(True, axis="y", alpha=0.3)
    return fig


def mean_std_bands(plt, resolutions: Sequence[int], series: Dict[str, tuple], ylabel: str):
    """Mean +/- one std per resolution over the examples, one line per method."""
    fig, ax = plt.subplots(figsize=(10, 7))
    for name, (mean, std) in series.items():
        mean, std = np.asarray(mean, dtype=float), np.asarray(std, dtype=float)
        ax.plot(resolutions, mean, "o-", label=name)
        ax.fill_between(resolutions, np.maximum(mean - std, 1e-30), mean + std, alpha=0.25)
    ax.set_yscale("log")
    _log_resolution_axis(ax, resolutions, ylabel)
    return fig


def scatter_vs_k(plt, k_sum: np.ndarray, series: Dict[str, np.ndarray], ylabel: str):
    """Each example's error against its k1 + k2."""
    fig, ax = plt.subplots(figsize=(10, 7))
    for name, values in series.items():
        ax.scatter(k_sum, values, label=name, alpha=0.8)
    ax.set_yscale("log")
    ax.set_xlabel("k1 + k2")
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    ax.legend()
    return fig


def computation_times(plt, resolutions: Sequence[int], times: Dict[str, Sequence[float]]):
    """Wall ms per resolution, one line per method."""
    fig, ax = plt.subplots(figsize=(10, 7))
    for name, values in times.items():
        ax.plot(resolutions, np.asarray(values, dtype=float) * 1e3, "o-", label=name)
    ax.set_yscale("log")
    _log_resolution_axis(ax, resolutions, "Wall-clock time (ms)")
    return fig


def grouped_bars(plt, group_labels: Sequence[str], series: Dict[str, Sequence[float]],
                 ylabel: str, log: bool = False):
    """One group of bars per label, one bar per series."""
    x = np.arange(len(group_labels))
    width = 0.8 / max(len(series), 1)
    fig, ax = plt.subplots(figsize=(max(8, 2 * len(group_labels)), 6))
    for i, (name, values) in enumerate(series.items()):
        ax.bar(x + (i - (len(series) - 1) / 2) * width, values, width, label=name)
    ax.set_xticks(x, group_labels, rotation=20, ha="right")
    ax.set_ylabel(ylabel)
    if log:
        ax.set_yscale("log")
    ax.grid(True, axis="y", alpha=0.3)
    ax.legend()
    return fig


def cross_section(plt, fields: Dict[str, np.ndarray], row: int, title: str):
    """Row ``row`` of each field against x in [0, 1]."""
    fig, ax = plt.subplots(figsize=(10, 6))
    for label, field in fields.items():
        ax.plot(np.linspace(0, 1, field.shape[-1]), field[row], label=label)
    ax.set_xlabel("x")
    ax.set_ylabel("u")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    return fig


def sample_indices(n_total: int, n_samples: int, seed: int) -> np.ndarray:
    """The samples :func:`dataset_samples` shows: ``min(n_samples, n_total)``
    distinct indices from ``np.random.default_rng(seed)``, as the JAX package
    draws them."""
    rng = np.random.default_rng(seed)
    return rng.choice(n_total, size=min(n_samples, n_total), replace=False)


def dataset_samples(plt, samples: Dict[str, np.ndarray], indices: Sequence[int]):
    """One row per sample: coarse u, fine u, theta and f. ``samples`` holds
    ``u_coarse``, ``u_fine``, ``theta_fine``, ``f_fine`` and ``is_subdomain``
    of the samples ``indices`` of a dataset, in that order."""
    n = len(indices)
    fig, axes = plt.subplots(n, 4, figsize=(16, 3 * n), squeeze=False)
    for i, idx in enumerate(indices):
        sub = " (subdomain)" if samples["is_subdomain"][i] else ""
        panels = [(f"Coarse u {idx}{sub}", samples["u_coarse"][i]),
                  (f"Fine u {idx}", samples["u_fine"][i]),
                  (f"Theta {idx}", samples["theta_fine"][i]),
                  (f"Forcing {idx}", samples["f_fine"][i])]
        for ax, (title, field) in zip(axes[i], panels):
            im = ax.imshow(field)
            ax.set_title(title)
            ax.set_xticks([])
            ax.set_yticks([])
            fig.colorbar(im, ax=ax, fraction=0.046)
    return fig
