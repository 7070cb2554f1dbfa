"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with ``--trace
1``), ``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number the comparison with the plain reference read, with its limit. The
same checks are the last lines of standard error.

Exits non-zero, printing no result, without a CUDA card, or when JAX or the
JAX package is loaded once the window has closed. Runs on the upper half of
the CPU cores the process is allowed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # one process on the upper half of the cores it may use, set before any
    # library starts a thread: on the card's host the lower cores also serve
    # the machine's own work, and a host-bound train step there spread 2-3x
    # wider from run to run (PERF.md)
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpus[len(cpus) // 2:])

    from portbench import harness

    harness.use_checkout_caches()
    cell = harness.load_cell(args.workload)
    import torch

    chips = cell.spec.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START,
                         torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
