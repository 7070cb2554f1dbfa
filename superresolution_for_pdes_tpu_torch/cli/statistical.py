"""Statistical benchmark CLI (port of ``cli/statistical.py``).

    python -m superresolution_for_pdes_tpu_torch statistical --bundle BUNDLE \\
        --n_examples 20 --seed 3 --out results/statistical_bundle [--device cuda]

Flags as ``resolution_comparison``'s, plus ``--n_examples`` and
``--theta_range``. Writes ``statistical_results.json``,
``statistical_results.csv``, ``summary.txt`` (and figures where matplotlib is
installed) to ``--out``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    from superresolution_for_pdes_tpu_torch.cli.resolution_comparison import (
        add_cascade_flags,
        resolve_cascade,
    )
    from superresolution_for_pdes_tpu_torch.device import resolve_device
    from superresolution_for_pdes_tpu_torch.eval.statistical import run_statistical_benchmark

    parser = argparse.ArgumentParser(description="N-example statistical benchmark with timings")
    add_cascade_flags(parser)
    parser.add_argument("--n_examples", type=int, default=10)
    parser.add_argument("--k", type=float, nargs=2, default=(8.0, 12.0))
    parser.add_argument("--theta_range", type=float, nargs=2, default=(0.5, 2.0),
                        help="scene theta ~ U(lo, hi); 1 1 gives constant theta")
    parser.add_argument("--out", type=str, default="results/statistical")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cascade = resolve_cascade(args, device)
    result = run_statistical_benchmark(
        cascade.pop("model"), cascade.pop("variables"), args.seed,
        n_examples=args.n_examples, resolutions=tuple(args.resolutions),
        k_range=tuple(args.k), save_dir=args.out, theta_range=tuple(args.theta_range),
        **cascade)
    if result.get("amp_levels"):
        print("amp_levels:", [(round(a, 4) if isinstance(a, float) else
                               f"<{len(a)} band gains>") for a in result["amp_levels"]])
    for res, a in result["aggregate"].items():
        print(f"{res}x{res}: ML MAE {a['ml_mae_mean']:.3e}+/-{a['ml_mae_std']:.1e} | "
              f"bilinear {a['bilinear_mae_mean']:.3e} | advantage {a['ml_advantage']:.1f}x | "
              f"rel-L2 ml {a['ml_rel_l2_mean']:.3f} bl {a['bilinear_rel_l2_mean']:.3f} | "
              f"ml {a['ml_time_mean']*1e3:.2f} ms, solve {a['solve_time_mean']*1e3:.2f} ms")
    return result


if __name__ == "__main__":
    main()
