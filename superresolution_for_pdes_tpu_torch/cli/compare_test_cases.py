"""Generalization-grid CLI (port of ``cli/compare_test_cases.py``).

    python -m superresolution_for_pdes_tpu_torch compare_test_cases --model_path RUN \\
        --n_samples 10 --seed 0 --out results/test_cases [--device cuda]

    # the routed deployment (reports/RECIPES.md:98-104)
    python -m superresolution_for_pdes_tpu_torch compare_test_cases --expert_const A \\
        --expert_varying B --expert_const_highk C --k_threshold 6.0 \\
        --expert_varying_highk D --k_threshold_varying 6.5 --n_samples 10

The five sets of ``eval.test_cases.GRID`` (in/out-of-sample k x constant/
varying theta, and the training-like set), ``--n_samples`` each, ML against
bilinear and bicubic at 40^2. A single ``--model_path`` is evaluated with
dataset normalization, as in the JAX package; routed experts each with
their own. Writes ``<label>_metrics.json`` per set and
``comprehensive_test_results.json`` (and the bar charts where matplotlib is
installed) to ``--out``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    from superresolution_for_pdes_tpu_torch.cli import add_router_flags

    parser = argparse.ArgumentParser(
        description="in/out-of-sample x const/varying-theta generalization grid")
    parser.add_argument("--model_path", type=str, default=None)
    add_router_flags(parser)
    parser.add_argument("--symmetrize", action="store_true",
                        help="average each expert over the 8 square symmetries")
    parser.add_argument("--n_samples", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="results/test_cases")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from superresolution_for_pdes_tpu_torch.cli import resolve_model, resolve_router
    from superresolution_for_pdes_tpu_torch.device import resolve_device
    from superresolution_for_pdes_tpu_torch.eval.test_cases import run_generalization_grid

    device = resolve_device(args.device)
    model, variables = resolve_router(args, device), None
    if model is None:
        model, variables, _ = resolve_model(args.model_path, device=device)
    results = run_generalization_grid(model, variables, args.seed, n_samples=args.n_samples,
                                      save_dir=args.out, symmetrize=args.symmetrize,
                                      device=device)
    for label, result in results.items():
        s = result["summary"]
        print(f"{label}: ML MAE {s['ml']['mae']:.6e} | bilinear MAE {s['bilinear']['mae']:.6e}")
    return results


if __name__ == "__main__":
    main()
