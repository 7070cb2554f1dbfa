"""Serving CLI: upscale a scene with a saved cascade bundle, or assemble one
from expert checkpoints, calibrate it and save it (port of
``cli/upscale.py``).

    # freeze a bundle once (scripts/rebuild_champion.sh:133-140)
    python -m superresolution_for_pdes_tpu_torch upscale --model_path R7 \\
        --model_path_level1 SFL1E --model_path_level 2 SFL2F \\
        --model_path_level 3 SFL34G --model_path_level 4 SFL34G \\
        --stats_mode tile --tile_levels 40 80 80 \\
        --amp_calibrate 32 --amp_k 8 12 --amp_bpo 4 \\
        --save_bundle results/champion_bundle --target 640 --out results/upscaled

    # serve it
    python -m superresolution_for_pdes_tpu_torch upscale --bundle BUNDLE \\
        --k 10 11 --seed 0 --target 640 --out results/upscaled [--device cuda]

Model paths are run directories of the port's ``train`` command or
reference ``.pth`` checkpoints. With
``--amp_calibrate N`` the assembled cascade gets grid modal gains fit on N
self-generated scenes (``cascade.modal.calibrate_modal``, seed
``--amp_seed``). The scene comes from ``--scene`` (an npz with ``u40`` and
``f<r>``/``theta<r>`` per level) or is self-generated from ``--k``/``--seed``
(then the exact solution is known and ``metrics.json`` holds MAE and relative
L2 per level). Writes ``ml_{r}x{r}.npy`` per level and ``metrics.json``. A
bundle must be in the port's format (``scripts/jax_bundle_to_torch.py``
converts a JAX one).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def main(argv=None) -> None:
    from superresolution_for_pdes_tpu_torch.cascade.multires import solve_multi_resolution
    from superresolution_for_pdes_tpu_torch.cascade.upscale import level_resolutions
    from superresolution_for_pdes_tpu_torch.cli import add_level_expert_flags
    from superresolution_for_pdes_tpu_torch.device import resolve_device
    from superresolution_for_pdes_tpu_torch.eval.metrics import compute_metrics

    parser = argparse.ArgumentParser(
        description="Upscale a scene with a (saved or assembled) cascade bundle")
    parser.add_argument("--bundle", type=str, default=None,
                        help="run a saved deployment bundle (ignores the model and "
                        "calibration flags below)")
    parser.add_argument("--model_path", type=str, default=None)
    add_level_expert_flags(parser)
    parser.add_argument("--stats_mode", choices=["scene", "tile"], default="tile",
                        help="honest stats modes only: deployment has no oracle")
    parser.add_argument("--overlap_levels", type=int, nargs="+", default=None,
                        metavar="0/1")
    parser.add_argument("--tile_levels", type=int, nargs="+", default=None, metavar="T",
                        help="per-level coarse tile size (trailing levels reuse the "
                        "last; default 20)")
    parser.add_argument("--amp_calibrate", type=int, default=0,
                        help="modal-calibrate (grid kind) on N self-generated scenes "
                        "before running/saving")
    parser.add_argument("--amp_k", type=float, nargs=2, default=(8.0, 12.0))
    parser.add_argument("--amp_bpo", type=int, default=4)
    parser.add_argument("--amp_seed", type=int, default=100)
    parser.add_argument("--save_bundle", type=str, default=None,
                        help="freeze the assembled configuration to this dir")
    parser.add_argument("--scene", type=str, default=None,
                        help="npz with u40 and f<r>/theta<r> per target level; "
                        "default: self-generate from --k/--seed")
    parser.add_argument("--k", type=float, nargs=2, default=(10.0, 11.0))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--target", type=int, default=640)
    parser.add_argument("--out", type=str, default="results/upscaled")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    resolutions = level_resolutions(40, args.target)
    truth = None
    if args.scene is not None:
        with np.load(args.scene) as z:
            scene = {
                "u": {40: torch.as_tensor(z["u40"], device=device)},
                "f": {r: torch.as_tensor(z[f"f{r}"], device=device) for r in resolutions},
                "theta": {r: torch.as_tensor(z[f"theta{r}"], device=device)
                          for r in resolutions},
            }
    else:
        full = solve_multi_resolution(args.seed, resolutions=resolutions,
                                      k_range=tuple(args.k), device=device)
        scene = {"u": {40: full["u"][40]}, "f": full["f"], "theta": full["theta"]}
        truth = full["u"]

    if args.bundle is not None:
        from superresolution_for_pdes_tpu_torch.deploy import run_bundle

        outs = run_bundle(args.bundle, scene, args.target, device=device)
    else:
        outs = _assemble_and_run(args, scene, device)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {}
    for res, field in outs.items():
        np.save(out_dir / f"ml_{res}x{res}.npy", field.cpu().numpy())
        if truth is not None:
            m = compute_metrics(field, truth[res])
            report[res] = {"mae": float(m["mae"]), "relative_l2": float(m["relative_l2"])}
            print(f"{res}x{res}: MAE {report[res]['mae']:.3e} "
                  f"rel-L2 {report[res]['relative_l2']:.3f}")
    (out_dir / "metrics.json").write_text(json.dumps(report, indent=2))
    print(f"fields written to {out_dir}")


def _assemble_and_run(args, scene, device):
    """The model-assembly route: experts from checkpoints, optional grid modal
    calibration, optional bundle, then the cascade on ``scene``."""
    from superresolution_for_pdes_tpu_torch.cascade.modal import calibrate_modal
    from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade
    from superresolution_for_pdes_tpu_torch.cli import model_config, resolve_level_experts, run_path
    from superresolution_for_pdes_tpu_torch.deploy import save_bundle

    model_path = run_path(args.model_path)
    model, variables, _ = resolve_level_experts(model_path, args, device=device)
    overlap = (tuple(bool(v) for v in args.overlap_levels)
               if args.overlap_levels is not None else False)
    coarse_tile = (tuple(int(v) for v in args.tile_levels)
                   if args.tile_levels is not None else 20)
    amp_levels = None
    if args.amp_calibrate > 0:
        amp_levels = calibrate_modal(
            model, variables, args.amp_seed, n_scenes=args.amp_calibrate,
            target_resolution=args.target, k_range=tuple(args.amp_k),
            stats_mode=args.stats_mode, overlap=overlap, bands_per_octave=args.amp_bpo,
            kind="grid", coarse_tile=coarse_tile, device=device)
    if args.save_bundle is not None:
        save_bundle(args.save_bundle, model_config(model_path), variables,
                    amp_levels=amp_levels, overlap=overlap,
                    stats_mode=args.stats_mode, coarse_tile=coarse_tile,
                    extra={"amp_k": list(args.amp_k), "amp_calibrate": args.amp_calibrate})
        print(f"bundle saved to {args.save_bundle}")
    return ml_cascade(model, variables, scene, args.target, stats_mode=args.stats_mode,
                      overlap=overlap, amp_levels=amp_levels, coarse_tile=coarse_tile)


if __name__ == "__main__":
    main()
