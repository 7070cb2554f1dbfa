"""Metrics logging (port of ``train/metrics.py``): per-epoch scalars appended
to ``metrics.jsonl`` and, with ``tensorboard=True``, mirrored to TensorBoard
event files under ``run_dir/tensorboard`` through
``torch.utils.tensorboard.SummaryWriter``; and a best-effort loss-curve plot
(skipped without matplotlib)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    """Appends ``{"step", **scalars}`` to ``metrics.jsonl``. TensorBoard is
    best-effort, as in the JAX package: where ``SummaryWriter`` does not
    import, the run goes on and one line says that TensorBoard is not
    written."""

    def __init__(self, run_dir: str | Path, tensorboard: bool = False):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.run_dir / "metrics.jsonl"
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as exc:
                print(f"TensorBoard is not written: torch.utils.tensorboard does not import "
                      f"({exc})")
            else:
                self._tb = SummaryWriter(log_dir=str(self.run_dir / "tensorboard"))

    def log(self, step: int, scalars: Dict[str, Any]) -> None:
        record = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        with self.path.open("a") as fh:
            fh.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for key, value in scalars.items():
                self._tb.add_scalar(key, float(value), step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def read_metrics(run_dir: str | Path) -> list[dict]:
    path = Path(run_dir) / "metrics.jsonl"
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines() if line]


def plot_history(run_dir: str | Path, out_name: str = "training_history.png") -> Optional[Path]:
    """Loss-curve plot with the best epoch marked; None without matplotlib
    or without records."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    records = read_metrics(run_dir)
    if not records:
        return None
    epochs = [r["step"] + 1 for r in records]
    train = [r["train_loss"] for r in records]
    val = [r["val_loss"] for r in records]
    best_i = min(range(len(val)), key=val.__getitem__)
    fig, ax = plt.subplots(figsize=(12, 7))
    ax.plot(epochs, train, label="Training Loss")
    ax.plot(epochs, val, label="Validation Loss")
    ax.plot(epochs[best_i], val[best_i], "o", markersize=10,
            label=f"Best Model (Epoch {epochs[best_i]}, Loss: {val[best_i]:.6f})")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.set_title("Training and Validation Loss")
    ax.grid(True, alpha=0.3)
    ax.legend()
    out = Path(run_dir) / out_name
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out
