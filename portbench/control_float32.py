"""``control.py``'s readings of a training cell without its float64 reference.

    python3 portbench/control_float32.py --workload <cell> --seeds 1 2 3 [--program] \
        [--out readings.jsonl]

For a cell whose float64 reference step does not fit one card (``hat_train_b32``:
the float32 reference peaks at ~59 GB there, a float64 one would need ~120 GB),
this reads the same controls as ``control.py`` against the float32 reference,
on the inputs a run of the same seed makes: the reference in TF32
(``tf32``), the half-batch fault (``half_batch``), a second float32
reference run (``reference_again``) and, with ``--program``, the program's own
first steps (``program``). Each line also holds the float32 reference's peak
device memory (``reference_peak_bytes``). The benchmark's own runs never run
this; ``train_readings`` also runs on the CPU (where TF32 changes nothing),
as the tests run it at TINY sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, inputs, weights  # noqa: E402
from portbench.control import _tf32, detail  # noqa: E402


def train_readings(cell, seed: int, device, program: bool = False) -> dict:
    """The cell's gaps of the TF32 control, of the half-batch fault and of a
    second float32 reference run, each against the float32 reference, over
    the rows a run of ``seed`` checks; with ``program``, the program's first
    steps (the driver's set-up, no window) against the same reference."""
    drv, train = cell.driver, cell.config["train"]
    raw = inputs.training_set(weights.generator(seed, device, 6), train["data"])
    rows = drv._rows(weights.generator(seed, device, 7), raw["u_fine"].shape[0],
                     train["batch_size"])[: cell.traffic["checked_steps"]]
    _tf32(False)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    ref = drv.reference_steps(cell, seed, device, raw, rows)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    again = drv.reference_steps(cell, seed, device, raw, rows)
    half = drv.reference_steps(cell, seed, device, raw, rows, drop_half=True)
    _tf32(True)
    low = drv.reference_steps(cell, seed, device, raw, rows)
    _tf32(False)
    out = {"reference_peak_bytes": peak,
           "readings": {"tf32": detail(drv, low, ref), "half_batch": detail(drv, half, ref),
                        "reference_again": detail(drv, again, ref)}}
    if program:
        state = drv.setup(cell, seed, device)
        out["readings"]["program"] = detail(drv, state["program"], ref)
        del state
        if on_card:
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", action="append", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--program", action="store_true",
                        help="read the program's first steps beside them")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_float32: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for name in args.workload:
        cell = harness.load_cell(name)
        if cell.driver.UNIT == "scene":
            print(f"control_float32: {name} is a serving cell; run control.py", file=sys.stderr)
            return 2
        for seed in args.seeds:
            line = {"cell": name, "seed": seed, "limits": cell.limits,
                    **train_readings(cell, seed, device, args.program)}
            print(json.dumps(line), flush=True)
            if args.out is not None:
                args.out.parent.mkdir(parents=True, exist_ok=True)
                with args.out.open("a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
