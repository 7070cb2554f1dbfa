"""Subcommand dispatcher: ``python -m superresolution_for_pdes_tpu_torch <cmd> ...``.

The JAX package's nine commands, all ported.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "generate_data": "superresolution_for_pdes_tpu_torch.cli.generate_data",
    "train": "superresolution_for_pdes_tpu_torch.cli.train",
    "compare_methods": "superresolution_for_pdes_tpu_torch.cli.compare_methods",
    "out_of_sample": "superresolution_for_pdes_tpu_torch.cli.out_of_sample",
    "compare_test_cases": "superresolution_for_pdes_tpu_torch.cli.compare_test_cases",
    "resolution_comparison": "superresolution_for_pdes_tpu_torch.cli.resolution_comparison",
    "statistical": "superresolution_for_pdes_tpu_torch.cli.statistical",
    "diagnose": "superresolution_for_pdes_tpu_torch.cli.diagnose",
    "upscale": "superresolution_for_pdes_tpu_torch.cli.upscale",
}


def main():
    """Run the command named by ``sys.argv[1]``; returns what its ``main`` returns."""
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help") or sys.argv[1] not in COMMANDS:
        print("usage: python -m superresolution_for_pdes_tpu_torch <command> [args]")
        print("commands: " + ", ".join(COMMANDS))
        raise SystemExit(0 if len(sys.argv) >= 2 and sys.argv[1] in ("-h", "--help") else 2)
    return importlib.import_module(COMMANDS[sys.argv[1]]).main(sys.argv[2:])


if __name__ == "__main__":
    main()
