"""The controls of the comparison that decides ``correct``, read on the card.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--out readings.jsonl]

The control is the plain reference put in the program's place and computed
in the nearest precision below the configuration's: the configurations
state float32 with TF32 off, so the control runs with TF32 on for cuBLAS
and cuDNN, and is compared with the reference in float32 by the cell's own
numbers, on the inputs a run of the same seed makes. Training cells also
read a fault planted in the reference put in the program's place: half of
every batch left out, the mean taken over the rest. (A step that leaves the
state unchanged reads 1 on ``change_gap`` by that number's definition and
needs no run.)

The benchmark's own runs never run this. Its readings, with the program's
over a dozen seeds or more, set each limit in ``workloads/<cell>.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, inputs, weights  # noqa: E402


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def serve_readings(cell, seed: int, device) -> dict:
    """``field_err`` of the control on as many scenes as a run checks, the
    first of the seeded order in which a run of ``seed`` serves its pool."""
    drv, traffic = cell.driver, cell.traffic
    pool = inputs.scene_pool(weights.generator(seed, device, 3), traffic["pool_scenes"],
                             traffic["start"], traffic["target"], traffic["k_range"])
    experts, gains = drv._experts(cell, seed, device)
    order = np.random.default_rng(weights.derived_seed(seed, 4)).permutation(
        traffic["pool_scenes"])
    worst = 0.0
    for i in order[: traffic["check_requests"]]:
        _tf32(False)
        ref = drv.reference_fields(cell, experts, gains, pool, int(i), device)
        _tf32(True)
        low = drv.reference_fields(cell, experts, gains, pool, int(i), device)
        worst = max([worst] + [float((low[r] - ref[r]).abs().max() / ref[r].abs().max())
                               for r in ref])
    _tf32(False)
    return {"tf32": {"field_err": worst}}


def detail(drv, side: dict, ref: dict) -> dict:
    """The cell's gaps of ``side`` from ``ref`` with what a look needs: each
    step's loss gap, the widest leaf's change gap, and per quantity the gap
    of the median leaf and the three widest leaves over every leaf."""
    out = drv.gaps(side, ref)
    g_med = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][k] for k in moving)
    out["change_gap_widest_leaf"] = max(abs(side["change"][k] - ref["change"][k])
                                        / max(ref["change"][k], c_med) for k in moving)
    out["loss_gap_by_step"] = [abs(a - b) / abs(b) for a, b in zip(side["loss"], ref["loss"])]
    for key in ("grad", "change"):
        med = statistics.median(ref[key].values())
        rel = {k: abs(side[key][k] - v) / max(v, med) for k, v in ref[key].items()}
        out[f"{key}_gap_median_leaf"] = statistics.median(rel.values())
        out[f"{key}_widest_leaves"] = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    return out


def train_readings(cell, seed: int, device, program: bool = False) -> dict:
    """The cell's gaps of the control (TF32), of the half-batch fault and of
    a second float32 reference run, each against the float32 reference, and
    of the float32 reference against a float64 one, over the rows a run of
    ``seed`` checks; with ``program``, the program's own first steps (the
    driver's set-up, no window) against both references."""
    drv, train = cell.driver, cell.config["train"]
    raw = inputs.training_set(weights.generator(seed, device, 6), train["data"])
    rows = drv._rows(weights.generator(seed, device, 7), raw["u_fine"].shape[0],
                     train["batch_size"])[: cell.traffic["checked_steps"]]
    _tf32(False)
    ref = drv.reference_steps(cell, seed, device, raw, rows)
    again = drv.reference_steps(cell, seed, device, raw, rows)
    half = drv.reference_steps(cell, seed, device, raw, rows, drop_half=True)
    f64 = drv.reference_steps(cell, seed, device, raw, rows, dtype=torch.float64)
    _tf32(True)
    low = drv.reference_steps(cell, seed, device, raw, rows)
    _tf32(False)
    out = {"tf32": detail(drv, low, ref), "half_batch": detail(drv, half, ref),
           "reference_again": detail(drv, again, ref),
           "reference_vs_float64": detail(drv, ref, f64)}
    if program:
        state = drv.setup(cell, seed, device)
        out["program"] = detail(drv, state["program"], ref)
        out["program_vs_float64"] = detail(drv, state["program"], f64)
        del state
        torch.cuda.empty_cache()
    return out


def readings(cell, seed: int, device, program: bool = False) -> dict:
    if cell.driver.UNIT == "scene":
        return serve_readings(cell, seed, device)
    return train_readings(cell, seed, device, program)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", action="append", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--program", action="store_true",
                        help="training cells: read the program's first steps beside them")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for name in args.workload:
        cell = harness.load_cell(name)
        for seed in args.seeds:
            line = {"cell": name, "seed": seed, "limits": cell.limits,
                    "readings": readings(cell, seed, device, args.program)}
            print(json.dumps(line), flush=True)
            if args.out is not None:
                args.out.parent.mkdir(parents=True, exist_ok=True)
                with args.out.open("a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
