"""Out-of-sample evaluation CLI (port of ``cli/out_of_sample.py``).

    python -m superresolution_for_pdes_tpu_torch out_of_sample --model_path RUN \\
        --n_samples 5 --k 5 8 --seed 0 --out results/out_of_sample [--device cuda]

    # the routed deployment
    python -m superresolution_for_pdes_tpu_torch out_of_sample --expert_const A \\
        --expert_varying B [--expert_const_highk C --k_threshold 6.0] \\
        [--expert_varying_highk D --k_threshold_varying 6.5]

ML against bilinear and bicubic interpolation at 40^2 on ``--n_samples``
fresh samples with k ~ U(``--k``) and theta == 1 (``--varying_theta``: U(0.5,
2)). A single model is normalized as its run was trained (``config.json``).
Writes ``out_of_sample_metrics.json`` and ``average_metrics.json`` (and the
figures where matplotlib is installed) to ``--out``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    from superresolution_for_pdes_tpu_torch.cli import add_router_flags

    parser = argparse.ArgumentParser(description="Out-of-sample (k in U(5,8)) evaluation")
    parser.add_argument("--model_path", type=str, default=None)
    add_router_flags(parser)
    parser.add_argument("--n_samples", type=int, default=5)
    parser.add_argument("--k", type=float, nargs=2, default=(5.0, 8.0))
    parser.add_argument("--varying_theta", action="store_true",
                        help="draw theta ~ U(0.5, 2) instead of theta == 1")
    parser.add_argument("--symmetrize", action="store_true",
                        help="average over the 8 square symmetries")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="results/out_of_sample")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from superresolution_for_pdes_tpu_torch.cli import resolve_expert, resolve_router
    from superresolution_for_pdes_tpu_torch.device import resolve_device
    from superresolution_for_pdes_tpu_torch.eval.out_of_sample import evaluate_out_of_sample

    device = resolve_device(args.device)
    model, variables, normalization = resolve_router(args, device), None, "dataset"
    if model is None:
        model, variables, normalization = resolve_expert(args.model_path, device=device)
    result = evaluate_out_of_sample(
        model, variables, args.seed, n_samples=args.n_samples, k_range=tuple(args.k),
        save_dir=args.out, constant_theta=not args.varying_theta, normalization=normalization,
        symmetrize=args.symmetrize, device=device)
    for method, ms in result["summary"].items():
        print(f"{method}: MAE {ms['mae']:.6e} RMSE {ms['rmse']:.6e}")
    return result


if __name__ == "__main__":
    main()
