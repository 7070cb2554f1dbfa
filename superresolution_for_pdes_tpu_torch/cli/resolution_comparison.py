"""Resolution-sweep CLI (port of ``cli/resolution_comparison.py``).

    python -m superresolution_for_pdes_tpu_torch resolution_comparison \\
        --bundle BUNDLE --k 10 11 --seed 0 [--refine_cycles 2] \\
        --out results/resolution_bundle [--device cuda]

With ``--bundle`` the model, per-level experts, gains, overlap schedule, tile
sizes and stats mode come from the bundle's manifest; otherwise from
``--model_path`` and the per-level expert and calibration flags. Writes
``resolution_metrics.json`` (and figures where matplotlib is installed) to
``--out``. ``--shard_tiles`` splits the tile batch of every model call over
all the cards this process sees (one part on a one-card machine, which is
the unsplit call).
"""

from __future__ import annotations

import argparse


def add_cascade_flags(parser) -> None:
    """The model, schedule and calibration flags of both eval commands."""
    from superresolution_for_pdes_tpu_torch.cli import add_level_expert_flags

    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--bundle", type=str, default=None,
                        help="run a saved deployment bundle: model, per-level experts, "
                        "modal gains, overlap schedule and stats mode all come from its "
                        "manifest")
    add_level_expert_flags(parser)
    parser.add_argument("--resolutions", type=int, nargs="+", default=[80, 160, 320, 640])
    parser.add_argument("--stats_mode", choices=["oracle", "scene", "train", "tile"],
                        default="oracle")
    parser.add_argument("--overlap", action="store_true",
                        help="half-tile overlapping windows with feathered blending")
    parser.add_argument("--overlap_levels", type=int, nargs="+", default=None, metavar="0/1",
                        help="per-level overlap schedule (trailing levels reuse the last; "
                        "overrides --overlap)")
    parser.add_argument("--tile_levels", type=int, nargs="+", default=None, metavar="T",
                        help="per-level coarse tile size (trailing levels reuse the last; "
                        "default 20)")
    parser.add_argument("--symmetrize", action="store_true",
                        help="average the model over the 8 square symmetries")
    parser.add_argument("--refine_cycles", type=int, default=0,
                        help="N V-cycles of the known PDE per level after the model")
    parser.add_argument("--amp_calibrate", type=int, default=0,
                        help="fit per-level gains on N self-generated scenes first")
    parser.add_argument("--amp_k", type=float, nargs=2, default=(6.0, 12.0))
    parser.add_argument("--amp_seed", type=int, default=100)
    parser.add_argument("--amp_mode", choices=("scalar", "modal"), default="scalar")
    parser.add_argument("--amp_kind", choices=("radial", "grid"), default="radial")
    parser.add_argument("--amp_bpo", type=int, default=4, help="modal bands per octave")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")


def resolve_cascade(args, device) -> dict:
    """The cascade's model, weights and schedule from ``--bundle`` or the
    model flags, as keyword arguments of the eval harnesses."""
    from superresolution_for_pdes_tpu_torch.cli import resolve_level_experts
    from superresolution_for_pdes_tpu_torch.deploy import load_bundle

    if args.bundle is not None:
        model, variables, amp_levels, manifest = load_bundle(args.bundle, device)
        train_stats, overlap = None, manifest["overlap"]
        coarse_tile, stats_mode = manifest["coarse_tile"], manifest["stats_mode"]
        amp_calibrate = 0
    else:
        model, variables, train_stats = resolve_level_experts(args.model_path, args,
                                                              device=device)
        amp_levels, amp_calibrate, stats_mode = None, args.amp_calibrate, args.stats_mode
        overlap = (tuple(bool(v) for v in args.overlap_levels)
                   if args.overlap_levels is not None else args.overlap)
        coarse_tile = (tuple(int(v) for v in args.tile_levels)
                       if args.tile_levels is not None else 20)
    if stats_mode == "train" and train_stats is None:
        raise SystemExit("--stats_mode train requires a checkpoint with saved norm_stats")
    return dict(model=model, variables=variables, stats_mode=stats_mode,
                train_stats=train_stats, overlap=overlap, coarse_tile=coarse_tile,
                amp_levels=amp_levels, amp_calibrate=amp_calibrate,
                symmetrize=args.symmetrize, refine_cycles=args.refine_cycles,
                amp_k=tuple(args.amp_k), amp_seed=args.amp_seed, amp_mode=args.amp_mode,
                amp_kind=args.amp_kind, amp_bpo=args.amp_bpo, device=device)


def main(argv=None) -> dict:
    import torch

    from superresolution_for_pdes_tpu_torch.device import resolve_device
    from superresolution_for_pdes_tpu_torch.eval.resolution import run_resolution_sweep

    parser = argparse.ArgumentParser(description="Multi-level cascade resolution sweep")
    add_cascade_flags(parser)
    parser.add_argument("--k", type=float, nargs=2, default=(10.0, 11.0))
    parser.add_argument("--shard_tiles", action="store_true",
                        help="split each model call's tiles over all visible cards")
    parser.add_argument("--out", type=str, default="results/resolution_comparison")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cascade = resolve_cascade(args, device)
    tile_devices = None
    if args.shard_tiles:
        tile_devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                        if device.type == "cuda" else [device])
        print(f"shard_tiles: the tiles of each model call split over {len(tile_devices)} "
              f"device(s): {', '.join(map(str, tile_devices))}")
    result = run_resolution_sweep(
        cascade.pop("model"), cascade.pop("variables"), args.seed,
        resolutions=tuple(args.resolutions), k_range=tuple(args.k), save_dir=args.out,
        tile_devices=tile_devices, **cascade)
    m = result["metrics"]
    for res in args.resolutions:
        line = (f"{res}x{res}: ML MAE {m['ml_multi_level'][res]['mae']:.6e} "
                f"(rel-L2 {m['ml_multi_level'][res]['relative_l2']:.3f}) | "
                f"bilinear {m['bilinear_direct'][res]['mae']:.6e} "
                f"(rel-L2 {m['bilinear_direct'][res]['relative_l2']:.3f}) | "
                f"bicubic {m['bicubic_direct'][res]['mae']:.6e}")
        if "ml_physics" in m:
            line += (f" | ml+physics MAE {m['ml_physics'][res]['mae']:.6e} "
                     f"(rel-L2 {m['ml_physics'][res]['relative_l2']:.3f})")
        print(line)
    return result


if __name__ == "__main__":
    main()
