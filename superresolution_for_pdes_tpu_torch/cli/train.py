"""Training CLI (port of ``cli/train.py``).

    python -m superresolution_for_pdes_tpu_torch train --generate --gen_stream \\
        --gen_theta mixed --gen_cascade_scenes 384 --gen_tiles_per_level 12 \\
        --gen_cascade_k 6 12 --normalization per_sample --scale_channels \\
        --physics_weight 0.3 --epochs 1000 [--device cuda]

Trains on ``--data`` (an ``.npz``) or, with ``--generate``, on a set
generated on the device from ``--gen_seed``; ``--gen_stream`` regenerates the
training split every ``--gen_every`` epochs. Writes
``<results>/<prefix>run_<timestamp>/`` with ``config.json``,
``metrics.jsonl``, ``best_model/`` and ``final_model/``.

Not yet ported (they raise): every ``--gen_selffeed_*`` flag,
``--fused_epochs > 1``, ``--data_parallel``, ``--multihost``,
``--tensorboard``, ``--dtype`` other than float32 and ``--model`` other than
``attention_unet``.
"""

from __future__ import annotations

import argparse

_SELFFEED_FLAGS = ("--gen_selffeed_scenes", "--gen_selffeed_model",
                   "--gen_selffeed_model_level1", "--gen_selffeed_model_level",
                   "--gen_selffeed_k", "--gen_selffeed_stats", "--gen_selffeed_finest",
                   "--gen_selffeed_harvest_from", "--gen_selffeed_overlap_levels",
                   "--gen_selffeed_amp", "--gen_selffeed_teacher_tile", "--gen_selffeed_chunk")


def _not_ported(args) -> list[str]:
    flags = [f for f in _SELFFEED_FLAGS if getattr(args, f.lstrip("-")) is not None]
    if args.fused_epochs > 1:
        flags.append("--fused_epochs > 1")
    flags += [f"--{name}" for name in ("data_parallel", "multihost", "tensorboard")
              if getattr(args, name)]
    if args.dtype != "float32":
        flags.append(f"--dtype {args.dtype}")
    if args.model != "attention_unet":
        flags.append(f"--model {args.model}")
    return flags


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Train the attention U-Net")
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
    parser.add_argument("--gen_tile_size", type=int, default=20,
                        help="coarse window of generated cascade tiles (fine windows are "
                        "2x); != 20 requires --gen_standard 0 --gen_subdomain 0")
    for flag in _SELFFEED_FLAGS:
        parser.add_argument(flag, nargs="*", default=None, help=argparse.SUPPRESS)
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

    from superresolution_for_pdes_tpu_torch.data.generate import generate_mixed_dataset
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

    def gen_mixed(seed_or_generator):
        return generate_mixed_dataset(
            seed_or_generator,
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
            device=device,
        )

    if args.generate:
        if args.gen_standard + args.gen_subdomain + args.gen_cascade_scenes == 0:
            parser.error("--generate with every sample count at 0")
        dataset = gen_mixed(args.gen_seed)
        print(f"generated {int(dataset['u_fine'].shape[0])} samples on {device} "
              f"(theta={args.gen_theta}, seed={args.gen_seed})")
    else:
        dataset = load_dataset(args.data, device=device)

    run_dir = create_run_dir(args.results, args.prefix)
    history = train_model(dataset, config, run_dir, resume_from=args.resume_from,
                          dataset_generator=gen_mixed if args.gen_stream else None,
                          device=device)
    print(f"best val loss {history['best_val_loss']:.6f} at epoch "
          f"{history['best_epoch'] + 1} ({history['num_epochs']} epochs); run dir {run_dir}")
    return history


if __name__ == "__main__":
    main()
