"""Subcommand dispatcher: ``python -m superresolution_for_pdes_tpu_torch <cmd> ...``.

``generate_data``, ``train`` and ``upscale`` are ported so far; the other
commands of the JAX package are listed in ROADMAP.md.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "generate_data": "superresolution_for_pdes_tpu_torch.cli.generate_data",
    "train": "superresolution_for_pdes_tpu_torch.cli.train",
    "upscale": "superresolution_for_pdes_tpu_torch.cli.upscale",
}


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help") or sys.argv[1] not in COMMANDS:
        print("usage: python -m superresolution_for_pdes_tpu_torch <command> [args]")
        print("commands: " + ", ".join(COMMANDS))
        raise SystemExit(0 if len(sys.argv) >= 2 and sys.argv[1] in ("-h", "--help") else 2)
    importlib.import_module(COMMANDS[sys.argv[1]]).main(sys.argv[2:])


if __name__ == "__main__":
    main()
