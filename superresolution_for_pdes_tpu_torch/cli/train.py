"""Training CLI (port of ``cli/train.py``).

    python -m superresolution_for_pdes_tpu_torch train --generate --gen_stream \\
        --gen_theta mixed --gen_cascade_scenes 384 --gen_tiles_per_level 12 \\
        --gen_cascade_k 6 12 --normalization per_sample --scale_channels \\
        --physics_weight 0.3 --epochs 1000 [--device cuda]

Trains on ``--data`` (an ``.npz``) or, with ``--generate``, on a set
generated on the device from ``--gen_seed``; ``--gen_stream`` regenerates the
training split every ``--gen_every`` epochs. ``--gen_selffeed_scenes N``
mixes in (or, with every other count at 0, trains on) self-fed cascade tiles
whose coarse inputs are a frozen teacher cascade's predictions
(``--gen_selffeed_model`` and its per-level experts). Writes
``<results>/<prefix>run_<timestamp>/`` with ``config.json``,
``metrics.jsonl``, ``best_model/`` and ``final_model/``. ``--model`` is any
name of the registry (``attention_unet``, ``attention_unet_wide``,
``resnet``).

Not yet ported (they raise): ``--fused_epochs > 1``, ``--data_parallel``,
``--multihost``, ``--tensorboard`` and ``--dtype`` other than float32.
"""

from __future__ import annotations

import argparse
import types


def _not_ported(args) -> list[str]:
    flags = ["--fused_epochs > 1"] if args.fused_epochs > 1 else []
    flags += [f"--{name}" for name in ("data_parallel", "multihost", "tensorboard")
              if getattr(args, name)]
    if args.dtype != "float32":
        flags.append(f"--dtype {args.dtype}")
    return flags


def _make_selffeed(args, device):
    """``generator -> self-fed tiles`` over the frozen teacher cascade,
    resolved once (with its per-level experts and, with ``--gen_selffeed_amp
    N``, its modal gains fit on N scenes), so that each regeneration pays only
    for the scene solves and one teacher cascade. The teacher's modules are
    its own: the cascade puts them in eval mode, never the student."""
    from superresolution_for_pdes_tpu_torch.cascade.modal import calibrate_modal
    from superresolution_for_pdes_tpu_torch.cli import resolve_level_experts
    from superresolution_for_pdes_tpu_torch.data.generate import selffeed_cascade_dataset

    ns = types.SimpleNamespace(model_path_level1=args.gen_selffeed_model_level1,
                               model_path_level=args.gen_selffeed_model_level)
    model, variables, _ = resolve_level_experts(args.gen_selffeed_model, ns, device=device)
    overlap = (tuple(bool(v) for v in args.gen_selffeed_overlap_levels)
               if args.gen_selffeed_overlap_levels is not None else False)
    teacher_tile = (tuple(int(v) for v in args.gen_selffeed_teacher_tile)
                    if args.gen_selffeed_teacher_tile is not None else 20)
    amp_levels = None
    if args.gen_selffeed_amp > 0:
        amp_levels = calibrate_modal(
            model, variables, 100, n_scenes=args.gen_selffeed_amp,
            target_resolution=args.gen_selffeed_finest, k_range=tuple(args.gen_selffeed_k),
            stats_mode=args.gen_selffeed_stats, kind="grid", overlap=overlap,
            coarse_tile=teacher_tile, device=device)

    def gen(generator):
        return selffeed_cascade_dataset(
            model, variables, generator, args.gen_selffeed_scenes,
            tiles_per_level=args.gen_tiles_per_level, k_range=tuple(args.gen_selffeed_k),
            finest=args.gen_selffeed_finest, stats_mode=args.gen_selffeed_stats,
            amp_levels=amp_levels, harvest_from=args.gen_selffeed_harvest_from,
            overlap=overlap, tile_size=args.gen_tile_size, teacher_tile=teacher_tile,
            scene_chunk=args.gen_selffeed_chunk)

    return gen


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Train a model of the registry")
    parser.add_argument("--data", type=str, default="data/pde_dataset.npz")
    parser.add_argument("--generate", action="store_true",
                        help="generate the training set on the device (seeded by --gen_seed) "
                        "instead of loading --data")
    parser.add_argument("--gen_seed", type=int, default=42)
    parser.add_argument("--gen_standard", type=int, default=1000)
    parser.add_argument("--gen_subdomain", type=int, default=1000)
    parser.add_argument("--gen_theta", choices=["constant", "varying", "mixed"],
                        default="constant")
    parser.add_argument("--gen_standard_k", type=float, nargs=2, default=(0.5, 5.0))
    parser.add_argument("--gen_subdomain_k", type=float, nargs=2, default=(0.5, 12.0))
    parser.add_argument("--gen_cascade_scenes", type=int, default=0)
    parser.add_argument("--gen_tiles_per_level", type=int, default=8)
    parser.add_argument("--gen_cascade_k", type=float, nargs=2, default=(0.5, 12.0))
    parser.add_argument("--gen_cascade_finest", type=int, default=640)
    parser.add_argument("--gen_cascade_coarsest", type=int, default=40)
    parser.add_argument("--gen_selffeed_scenes", type=int, default=0,
                        help="mix in self-fed cascade tiles whose coarse inputs are a frozen "
                        "model's own cascade predictions; requires --gen_selffeed_model")
    parser.add_argument("--gen_selffeed_model", type=str, default=None,
                        help="run dir of the frozen teacher (it serves every level without "
                        "an expert)")
    parser.add_argument("--gen_selffeed_model_level1", type=str, default=None,
                        help="optional level-1 expert of the teacher cascade")
    parser.add_argument("--gen_selffeed_model_level", nargs=2, action="append",
                        metavar=("LEVEL", "PATH"), default=None,
                        help="per-level teacher expert (repeatable), as the eval commands' "
                        "--model_path_level")
    parser.add_argument("--gen_selffeed_k", type=float, nargs=2, default=(8.0, 12.0))
    parser.add_argument("--gen_selffeed_stats", default="tile",
                        choices=["oracle", "scene", "train", "tile"],
                        help="stats mode of the teacher cascade")
    parser.add_argument("--gen_selffeed_finest", type=int, default=640,
                        help="finest resolution of the self-fed scenes")
    parser.add_argument("--gen_selffeed_harvest_from", type=int, default=None,
                        help="harvest only pairs whose coarse resolution is >= this")
    parser.add_argument("--gen_selffeed_overlap_levels", type=int, nargs="+", default=None,
                        metavar="0/1", help="per-level overlap schedule of the teacher")
    parser.add_argument("--gen_selffeed_amp", type=int, default=0,
                        help="fit the teacher's modal gains (grid kind) on N self-generated "
                        "scenes first")
    parser.add_argument("--gen_tile_size", type=int, default=20,
                        help="coarse window of generated cascade and self-fed tiles (fine "
                        "windows are 2x); != 20 requires --gen_standard 0 --gen_subdomain 0")
    parser.add_argument("--gen_selffeed_teacher_tile", type=int, nargs="+", default=None,
                        metavar="T", help="per-level tile schedule of the teacher (default 20)")
    parser.add_argument("--gen_selffeed_chunk", type=int, default=None,
                        help="generate the self-fed scenes in chunks of this many (must "
                        "divide --gen_selffeed_scenes)")
    parser.add_argument("--fused_epochs", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--gen_every", type=int, default=1,
                        help="with --gen_stream: regenerate every K epochs")
    parser.add_argument("--gen_stream", action="store_true",
                        help="regenerate the training split on the device every epoch "
                        "(requires --generate; validation stays on a fixed split)")
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--physics_weight", type=float, default=0.0)
    parser.add_argument("--coarse_noise_std", type=float, default=0.0,
                        help="train-time Gaussian noise on the coarse input channel")
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--model", type=str, default="attention_unet")
    parser.add_argument("--normalization", choices=["dataset", "per_sample"], default="dataset")
    parser.add_argument("--model_norm", choices=["batch", "group"], default="batch")
    parser.add_argument("--scale_channels", action="store_true",
                        help="append log-scale input channels (in_channels=5)")
    parser.add_argument("--multihost", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--early_stopping_patience", type=int, default=20)
    parser.add_argument("--plateau_patience", type=int, default=10)
    parser.add_argument("--results", type=str, default="results")
    parser.add_argument("--prefix", type=str, default="enhanced_")
    parser.add_argument("--tensorboard", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--data_parallel", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--resume_from", type=str, default=None,
                        help="checkpoint directory to resume the full training state from")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    not_ported = _not_ported(args)
    if not_ported:
        parser.error(f"{', '.join(not_ported)}: not yet ported to PyTorch (see ROADMAP.md)")
    if args.gen_stream and not args.generate:
        parser.error("--gen_stream requires --generate")
    selffeed = args.gen_selffeed_scenes > 0
    if selffeed and args.gen_selffeed_model is None:
        parser.error("--gen_selffeed_scenes requires --gen_selffeed_model")
    n_mixed = args.gen_standard + args.gen_subdomain + args.gen_cascade_scenes
    if args.generate and n_mixed == 0 and not selffeed:
        parser.error("--generate with every sample count at 0")
    if (args.gen_tile_size != 20 and selffeed
            and (args.gen_standard > 0 or args.gen_subdomain > 0)):
        parser.error("--gen_tile_size != 20 cannot be mixed with standard/subdomain samples; "
                     "set --gen_standard 0 --gen_subdomain 0")

    from superresolution_for_pdes_tpu_torch.data.generate import (
        combine_datasets,
        fold_in,
        generate_mixed_dataset,
        make_generator,
    )
    from superresolution_for_pdes_tpu_torch.data.io import load_dataset
    from superresolution_for_pdes_tpu_torch.device import resolve_device
    from superresolution_for_pdes_tpu_torch.train import TrainConfig, train_model
    from superresolution_for_pdes_tpu_torch.utils.runs import create_run_dir

    device = resolve_device(args.device)
    config = TrainConfig(
        batch_size=args.batch_size,
        num_epochs=args.epochs,
        learning_rate=args.lr,
        physics_weight=args.physics_weight,
        coarse_noise_std=args.coarse_noise_std,
        dtype=args.dtype,
        model=args.model,
        normalization=args.normalization,
        scale_channels=args.scale_channels,
        model_norm=args.model_norm,
        seed=args.seed,
        early_stopping_patience=args.early_stopping_patience,
        plateau_patience=args.plateau_patience,
        fused_epochs=args.fused_epochs,
        gen_every=args.gen_every,
    )

    dataset_generator = None
    if args.generate:
        selffeed_gen = _make_selffeed(args, device) if selffeed else None

        def dataset_generator(gen):
            """The mixed recipe, then the self-fed tiles drawn from
            ``fold_in(gen, 7)``: the same seed gives the same set."""
            dataset = None
            if n_mixed > 0:
                dataset = generate_mixed_dataset(
                    gen,
                    n_standard=args.gen_standard,
                    n_subdomain=args.gen_subdomain,
                    theta=args.gen_theta,
                    standard_k_range=tuple(args.gen_standard_k),
                    subdomain_k_range=tuple(args.gen_subdomain_k),
                    n_cascade_scenes=args.gen_cascade_scenes,
                    cascade_tiles_per_level=args.gen_tiles_per_level,
                    cascade_k_range=tuple(args.gen_cascade_k),
                    cascade_finest=args.gen_cascade_finest,
                    cascade_coarsest=args.gen_cascade_coarsest,
                    cascade_tile_size=args.gen_tile_size,
                )
            if selffeed_gen is not None:
                tiles = selffeed_gen(fold_in(gen, 7))
                dataset = tiles if dataset is None else combine_datasets(dataset, tiles)
            return dataset

        dataset = dataset_generator(make_generator(args.gen_seed, device))
        if selffeed:
            print(f"  {args.gen_selffeed_scenes} self-fed scenes (teacher "
                  f"{args.gen_selffeed_model}, stats {args.gen_selffeed_stats})")
        print(f"generated {int(dataset['u_fine'].shape[0])} samples on {device} "
              f"(theta={args.gen_theta}, seed={args.gen_seed})")
    else:
        dataset = load_dataset(args.data, device=device)

    run_dir = create_run_dir(args.results, args.prefix)
    history = train_model(dataset, config, run_dir, resume_from=args.resume_from,
                          dataset_generator=dataset_generator if args.gen_stream else None,
                          device=device)
    print(f"best val loss {history['best_val_loss']:.6f} at epoch "
          f"{history['best_epoch'] + 1} ({history['num_epochs']} epochs); run dir {run_dir}")
    return history


if __name__ == "__main__":
    main()
