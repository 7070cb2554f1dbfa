"""Dataset generation CLI (port of ``cli/generate_data.py``).

    python -m superresolution_for_pdes_tpu_torch generate_data --n_standard 1000 \\
        --n_subdomain 1000 --theta mixed --n_cascade_scenes 64 --out data [--device cuda]

Writes ``<out>/pde_dataset.npz`` in the JAX package's schema. With
``--n_selffeed_scenes N --selffeed_model RUN`` it appends self-fed cascade
tiles from N scenes (to ``--cascade_finest``, scene stats) whose coarse
inputs are that model's own cascade predictions. ``--plot_samples N``
(default 20; 0 draws none) draws N random samples (coarse u, fine u, theta,
f) into ``<out>/dataset_samples/random_samples.png`` where matplotlib is
installed.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(description="Generate PDE training data on the device")
    parser.add_argument("--n_standard", type=int, default=1000)
    parser.add_argument("--n_subdomain", type=int, default=1000)
    parser.add_argument("--standard_k", type=float, nargs=2, default=(0.5, 5.0))
    parser.add_argument("--subdomain_k", type=float, nargs=2, default=(0.5, 12.0))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--out", type=str, default="data")
    parser.add_argument("--theta", choices=["constant", "varying", "mixed"], default="constant",
                        help="constant: theta == 1; varying: theta ~ U(0.5, 2) pointwise; "
                        "mixed: both strata")
    parser.add_argument("--n_cascade_scenes", type=int, default=0,
                        help="additionally mix in cascade-consistent tiles from this many "
                        "multi-resolution scenes")
    parser.add_argument("--cascade_tiles_per_level", type=int, default=8)
    parser.add_argument("--cascade_k", type=float, nargs=2, default=(0.5, 12.0))
    parser.add_argument("--cascade_finest", type=int, default=640)
    parser.add_argument("--n_selffeed_scenes", type=int, default=0,
                        help="mix in self-fed cascade tiles (coarse inputs are a model's own "
                        "cascade predictions); requires --selffeed_model")
    parser.add_argument("--selffeed_model", type=str, default=None,
                        help="run dir whose cascade makes the self-fed coarse inputs")
    parser.add_argument("--selffeed_k", type=float, nargs=2, default=(0.5, 12.0))
    parser.add_argument("--plot_samples", type=int, default=20,
                        help="plot this many random samples as a visual check; 0 disables")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.n_selffeed_scenes > 0 and args.selffeed_model is None:
        parser.error("--n_selffeed_scenes requires --selffeed_model")

    from superresolution_for_pdes_tpu_torch.cli import resolve_model
    from superresolution_for_pdes_tpu_torch.data.generate import (
        cascade_resolutions,
        combine_datasets,
        fold_in,
        generate_mixed_dataset,
        make_generator,
        selffeed_cascade_dataset,
    )
    from superresolution_for_pdes_tpu_torch.data.io import save_dataset
    from superresolution_for_pdes_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    print(f"generating {args.n_standard} standard + {args.n_subdomain} subdomain "
          f"samples (theta={args.theta}) on {device}...")
    gen = make_generator(args.seed, device)
    dataset = generate_mixed_dataset(
        gen,
        n_standard=args.n_standard,
        n_subdomain=args.n_subdomain,
        theta=args.theta,
        standard_k_range=tuple(args.standard_k),
        subdomain_k_range=tuple(args.subdomain_k),
        n_cascade_scenes=args.n_cascade_scenes,
        cascade_tiles_per_level=args.cascade_tiles_per_level,
        cascade_k_range=tuple(args.cascade_k),
        cascade_finest=args.cascade_finest,
        device=device,
    )
    if args.n_cascade_scenes > 0:
        pairs = len(cascade_resolutions(40, args.cascade_finest)) - 1
        print(f"  + {args.n_cascade_scenes * args.cascade_tiles_per_level * pairs} "
              "cascade-consistent tiles")
    if args.n_selffeed_scenes > 0:
        model, variables, _ = resolve_model(args.selffeed_model, device=device)
        selffeed = selffeed_cascade_dataset(
            model, variables, fold_in(gen, 7), args.n_selffeed_scenes,
            tiles_per_level=args.cascade_tiles_per_level, k_range=tuple(args.selffeed_k),
            finest=args.cascade_finest)
        print(f"  + {int(selffeed['u_fine'].shape[0])} self-feeding cascade tiles")
        dataset = combine_datasets(dataset, selffeed)
    path = save_dataset(dataset, args.out)
    print(f"saved {int(dataset['u_fine'].shape[0])} samples -> {path}")
    if args.plot_samples > 0:
        from superresolution_for_pdes_tpu_torch.eval import plots

        out_dir = Path(path).parent / "dataset_samples"
        out_dir.mkdir(parents=True, exist_ok=True)
        indices = plots.sample_indices(int(dataset["u_fine"].shape[0]), args.plot_samples,
                                       args.seed)
        idx = torch.as_tensor(indices, device=device)
        samples = {k: dataset[k][idx].cpu().numpy()
                   for k in ("u_coarse", "u_fine", "theta_fine", "f_fine", "is_subdomain")}
        for figure in plots.draw_figures([(out_dir / "random_samples.png", plots.dataset_samples,
                                           dict(samples=samples, indices=indices))]):
            print(f"sample plots -> {figure}")
    return path


if __name__ == "__main__":
    main()
