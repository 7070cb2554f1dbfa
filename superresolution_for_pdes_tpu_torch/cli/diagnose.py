"""Scene-conditioned failure diagnosis over a statistical run's JSON (port of
``cli/diagnose.py``; no model, no device).

    python -m superresolution_for_pdes_tpu_torch diagnose \\
        --results results/statistical/statistical_results.json [--focus 160]

Prints the Spearman table of scene features against the ML relative L2 per
resolution and the worst scenes; ``--out`` also writes the diagnosis JSON.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="per-scene cascade failure diagnosis")
    parser.add_argument("--results", type=str, required=True,
                        help="statistical_results.json from the statistical command")
    parser.add_argument("--focus", type=int, default=None,
                        help="resolution whose worst scenes to list (default: all)")
    parser.add_argument("--top", type=int, default=5)
    parser.add_argument("--stride", type=float, default=20.0,
                        help="tile-to-tile advance in input-grid points for the tile_misalign "
                        "features: 20 for non-overlap runs, 10 for overlap-feathered levels")
    parser.add_argument("--out", type=str, default=None,
                        help="optional path for the diagnosis JSON")
    args = parser.parse_args(argv)

    from superresolution_for_pdes_tpu_torch.eval.diagnose import diagnose_file, format_report

    diag = diagnose_file(args.results, focus=args.focus, stride=args.stride)
    print(format_report(diag, focus=args.focus, top=args.top))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(diag, indent=2, default=float))
    return diag


if __name__ == "__main__":
    main()
