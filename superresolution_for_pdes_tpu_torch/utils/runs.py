"""Run-directory management (port of ``utils/runs.py``): one
``<base>/<prefix>run_<timestamp>`` directory per training run, and discovery
of the newest one that holds a given artifact."""

from __future__ import annotations

from datetime import datetime
from pathlib import Path


def create_run_dir(base_dir: str | Path = "results", prefix: str = "enhanced_") -> Path:
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    run_dir = Path(base_dir) / f"{prefix}run_{stamp}"
    run_dir.mkdir(parents=True, exist_ok=False)
    return run_dir


def find_latest_run_dir(base_dir: str | Path = "results", require: str = "best_model") -> Path:
    base = Path(base_dir)
    candidates = sorted(
        (d for d in base.glob("*run_*") if d.is_dir() and (d / require).exists()),
        key=lambda d: d.stat().st_mtime,
    )
    if not candidates:
        raise FileNotFoundError(f"no run dir containing {require!r} under {base}")
    return candidates[-1]
