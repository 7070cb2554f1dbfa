"""Command-line entry points (``python -m superresolution_for_pdes_tpu_torch <cmd>``)
and the model resolution they share (port of ``cli/__init__.py``).

A model path is a run directory of the port's ``train`` (``config.json``
beside ``best_model/checkpoint.pt``), a checkpoint directory itself
(``checkpoint.pt`` in it), or a reference ``.pth`` (its run's
``config.json``, if any, beside it); ``None`` means the newest run under
``results``. The JAX package's ``enable_compilation_cache`` configures XLA's
on-disk cache and has no counterpart here, since PyTorch compiles nothing
ahead of a run.
"""

from __future__ import annotations

import json
from pathlib import Path


def _run_config(path: Path) -> dict:
    """The ``config.json`` of the run that ``path`` names (a run dir, a
    checkpoint dir in it, or a ``.pth`` beside it), or ``{}``."""
    from superresolution_for_pdes_tpu_torch.train.checkpoint import FILENAME

    run_dir = path.parent if path.suffix == ".pth" or (path / FILENAME).exists() else path
    cfg_path = run_dir / "config.json"
    return json.loads(cfg_path.read_text()) if cfg_path.exists() else {}


def _load_model(path: Path, device):
    """``(model, state_dict, train_stats)`` from one run or checkpoint dir, or
    a reference ``.pth`` (which holds no normalization statistics)."""
    from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
    from superresolution_for_pdes_tpu_torch.models import build_model
    from superresolution_for_pdes_tpu_torch.models.torch_import import load_torch_checkpoint
    from superresolution_for_pdes_tpu_torch.train.checkpoint import FILENAME, restore_checkpoint

    if path.suffix == ".pth":
        state = {k: v.to(device) for k, v in load_torch_checkpoint(path).items()}
        train_stats = None
    else:
        restored = restore_checkpoint(path if (path / FILENAME).exists() else path / "best_model",
                                      map_location=device)
        ns = restored.get("norm_stats")
        state, train_stats = restored["model"], None if ns is None else NormStats(**ns)
    cfg = _run_config(path)
    overrides = {}
    if cfg.get("scale_channels"):
        overrides["in_channels"] = 5
    if cfg.get("model_norm", "batch") != "batch":
        overrides["norm"] = cfg["model_norm"]
    model = build_model(cfg.get("model", "attention_unet"), **overrides).to(device).eval()
    return model, state, train_stats


def resolve_model(model_path: str | None, results_dir: str = "results", device=None):
    """``(model, state_dict, train_stats)`` from a run or checkpoint directory
    or a reference ``.pth``, or the newest run under ``results_dir`` when
    ``model_path`` is None, on ``device`` (default ``cuda``; raises without a
    card). ``train_stats`` is the checkpoint's normalization statistics, or
    None when it has none."""
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


def resolve_expert(model_path: str | None, results_dir: str = "results", device=None):
    """``(model, state_dict, normalization)`` for one routed expert, as
    :func:`resolve_model` loads it; the normalization mode (``"dataset"`` or
    ``"per_sample"``) comes from the run's ``config.json`` (``"dataset"``
    without one), so that inputs are built as the expert was trained."""
    if model_path is None:
        from superresolution_for_pdes_tpu_torch.utils.runs import find_latest_run_dir

        model_path = find_latest_run_dir(results_dir)
        print(f"using latest run: {model_path}")
    model, state, _ = resolve_model(model_path, results_dir, device)
    return model, state, _run_config(Path(model_path)).get("normalization", "dataset")


def add_router_flags(parser) -> None:
    """The routed-expert flags of ``out_of_sample`` and
    ``compare_test_cases``."""
    parser.add_argument("--expert_const", type=str, default=None,
                        help="theta == 1 expert; with --expert_varying, evaluate the "
                        "theta-regime-routed deployment instead of one checkpoint")
    parser.add_argument("--expert_varying", type=str, default=None)
    parser.add_argument("--expert_const_highk", type=str, default=None,
                        help="optional expert for constant-theta high-wavenumber inputs, "
                        "routed by the FFT peak of the known forcing")
    parser.add_argument("--k_threshold", type=float, default=6.0)
    parser.add_argument("--expert_varying_highk", type=str, default=None,
                        help="optional expert for varying-theta high-wavenumber inputs")
    parser.add_argument("--k_threshold_varying", type=float, default=6.0)


def resolve_router(args, device):
    """The :class:`~superresolution_for_pdes_tpu_torch.models.router.RegimeRouter`
    the router flags name, or None without ``--expert_const``."""
    if (args.expert_const is None) != (args.expert_varying is None):
        raise SystemExit("--expert_const and --expert_varying must be given together")
    if args.expert_const is None:
        return None
    from superresolution_for_pdes_tpu_torch.models.router import RegimeRouter

    def expert(path):
        return None if path is None else resolve_expert(path, device=device)

    return RegimeRouter(expert(args.expert_const), expert(args.expert_varying),
                        const_high=expert(args.expert_const_highk),
                        varying_high=expert(args.expert_varying_highk),
                        k_threshold=args.k_threshold,
                        k_threshold_varying=args.k_threshold_varying)
