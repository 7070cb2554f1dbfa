"""Command-line entry points (``python -m superresolution_for_pdes_tpu_torch <cmd>``)
and the model resolution they share (port of ``cli/__init__.py``).

A model path is a run directory of the port's ``train`` (``config.json``
beside ``best_model/checkpoint.pt``), or a checkpoint directory itself
(``checkpoint.pt`` in it); ``None`` means the newest run under ``results``.
Not ported: reference ``.pth`` checkpoints and ``resolve_expert`` (the
router's) raise "not yet ported" (ROADMAP.md); the JAX package's
``enable_compilation_cache`` configures XLA's on-disk cache and has no
counterpart here, since PyTorch compiles nothing ahead of a run.
"""

from __future__ import annotations

import json
from pathlib import Path


def _load_model(path: Path, device):
    """``(model, state_dict, train_stats)`` from one run or checkpoint dir."""
    from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
    from superresolution_for_pdes_tpu_torch.models import build_model
    from superresolution_for_pdes_tpu_torch.train.checkpoint import FILENAME, restore_checkpoint

    if path.suffix == ".pth":
        raise NotImplementedError(
            f"{path}: reference .pth checkpoints are not yet ported to PyTorch (see "
            "ROADMAP.md); pass a run directory of the port's train command")
    ckpt_dir = path if (path / FILENAME).exists() else path / "best_model"
    restored = restore_checkpoint(ckpt_dir, map_location=device)
    ns = restored.get("norm_stats")
    train_stats = None if ns is None else NormStats(**ns)
    model_name, overrides = "attention_unet", {}
    cfg_path = (ckpt_dir.parent if ckpt_dir == path else path) / "config.json"
    if cfg_path.exists():
        cfg = json.loads(cfg_path.read_text())
        model_name = cfg.get("model", model_name)
        if cfg.get("scale_channels"):
            overrides["in_channels"] = 5
        if cfg.get("model_norm", "batch") != "batch":
            overrides["norm"] = cfg["model_norm"]
    model = build_model(model_name, **overrides).to(device).eval()
    return model, restored["model"], train_stats


def resolve_model(model_path: str | None, results_dir: str = "results", device=None):
    """``(model, state_dict, train_stats)`` from a run or checkpoint directory,
    or the newest run under ``results_dir`` when ``model_path`` is None, on
    ``device`` (default ``cuda``; raises without a card). ``train_stats`` is
    the checkpoint's normalization statistics, or None when it has none."""
    from superresolution_for_pdes_tpu_torch.device import resolve_device
    from superresolution_for_pdes_tpu_torch.utils.runs import find_latest_run_dir

    device = resolve_device(device)
    if model_path is None:
        model_path = find_latest_run_dir(results_dir)
        print(f"using latest run: {model_path}")
    path = Path(model_path)
    if not path.exists():
        raise FileNotFoundError(f"model not found at path: {path}")
    return _load_model(path, device)


def add_level_expert_flags(parser) -> None:
    """The per-level-expert flags every cascade command shares."""
    parser.add_argument("--model_path_level1", type=str, default=None,
                        help="optional level-1 expert checkpoint (same architecture): "
                        "used for the 40->80 step, with --model_path serving the "
                        "deeper levels")
    parser.add_argument("--model_path_level", nargs=2, action="append",
                        metavar=("LEVEL", "PATH"), default=None,
                        help="per-level expert, e.g. --model_path_level 2 "
                        "results/level2_run_x (repeatable); unlisted levels fall "
                        "back to --model_path")


def resolve_level_experts(model_path, args, results_dir: str = "results", device=None):
    """``(model, state_dict or tuple of them, train_stats)`` honouring the
    per-level expert flags. The tuple follows the cascade's convention (level
    ``i`` uses entry ``min(i, len - 1)``): expert checkpoints fill their
    1-based level slots and every other slot is the ``--model_path`` model.
    A path named twice is loaded once, so its weights are one object (and one
    directory in a saved bundle)."""
    model, variables, train_stats = resolve_model(model_path, results_dir, device)
    experts = {}
    if getattr(args, "model_path_level1", None) is not None:
        experts[1] = args.model_path_level1
    for lvl, path in (getattr(args, "model_path_level", None) or []):
        experts[int(lvl)] = path
    if not experts:
        return model, variables, train_stats
    if min(experts) < 1:
        raise SystemExit("--model_path_level levels are 1-based")
    seq = [variables] * (max(experts) + 1)
    loaded = {}
    for lvl, path in experts.items():
        key = str(Path(path).resolve())
        if key not in loaded:
            loaded[key] = resolve_model(path, results_dir, device)[1]
        seq[lvl - 1] = loaded[key]
    return model, tuple(seq), train_stats


def resolve_expert(model_path: str | None, results_dir: str = "results"):
    """The router's expert loader: not yet ported."""
    raise NotImplementedError("resolve_expert (the router's expert loader) is not yet "
                              "ported to PyTorch (see ROADMAP.md)")
