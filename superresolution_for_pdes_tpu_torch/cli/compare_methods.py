"""Single-level comparison CLI (port of ``cli/compare_methods.py``).

    python -m superresolution_for_pdes_tpu_torch compare_methods --model_path RUN \\
        [--data DATA.npz] --n_samples 10 --seed 0 --out results/compare_methods \\
        [--device cuda]

ML against bilinear and bicubic interpolation at 40^2, on the first
``--n_samples`` samples of ``--data`` or on a fresh test set (k in 0.5-5,
theta == 1) drawn from ``--seed``. Writes ``compare_metrics.json`` (and sample
figures where matplotlib is installed) to ``--out``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="ML vs interpolation at 40x40")
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--data", type=str, default=None,
                        help="npz dataset; a fresh test set when omitted")
    parser.add_argument("--n_samples", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="results/compare_methods")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from superresolution_for_pdes_tpu_torch.cli import resolve_model
    from superresolution_for_pdes_tpu_torch.device import resolve_device
    from superresolution_for_pdes_tpu_torch.eval.single_level import evaluate_dataset

    device = resolve_device(args.device)
    model, variables, _ = resolve_model(args.model_path, device=device)
    if args.data:
        from superresolution_for_pdes_tpu_torch.data.io import load_dataset

        data = {k: v[: args.n_samples] for k, v in load_dataset(args.data, device=device).items()}
    else:
        from superresolution_for_pdes_tpu_torch.data.generate import generate_test_dataset

        data = generate_test_dataset(args.seed, args.n_samples, (0.5, 5.0), constant_theta=True,
                                     device=device)
    result = evaluate_dataset(model, variables, data, label="compare", save_dir=args.out)
    for method, ms in result["summary"].items():
        print(f"{method}: MAE {ms['mae']:.6e} RMSE {ms['rmse']:.6e} max {ms['max_error']:.6e}")
    return result


if __name__ == "__main__":
    main()
