"""Run cells several times, one process a run, one after another, and
summarise the spread of each metric.

    python3 portbench/repeat.py --workload <cell> [--workload ...] --seeds 11 12 13 \\
        --seconds 20 [--trace 0|1] [--out results.jsonl]

Each run is ``portbench/run.py``; its result line, exit code, wall time and
the end of its standard error go to ``--out`` (JSON lines). The summary gives,
per cell and metric, the median and the spread: the distance between the
first and the third quartile (``statistics.quantiles(values, n=4)``) as a
share of the median, and each check's largest value.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def one(cell: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(RUN), "--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          capture_output=True, text=True, timeout=1500)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace, "rc": proc.returncode,
            "wall_s": time.perf_counter() - t0, "result": result,
            "stderr_tail": proc.stderr[-3000:]}


def spread(values: list) -> float:
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def summary(records: list) -> list:
    out = []
    for cell in dict.fromkeys(r["cell"] for r in records):
        done = [r["result"] for r in records if r["cell"] == cell and r["result"]]
        line = {"cell": cell, "runs": len(done),
                "correct": sum(bool(r["correct"]) for r in done), "metrics": {}, "checks": {}}
        for name in dict.fromkeys(k for r in done for k in r["metrics"]):
            vals = [r["metrics"][name]["value"] for r in done if name in r["metrics"]]
            line["metrics"][name] = {"median": statistics.median(vals), "spread": spread(vals),
                                     "values": vals}
        for name in dict.fromkeys(k for r in done for k in r["checks"]):
            line["checks"][name] = max(r["checks"][name]["value"] for r in done)
        out.append(line)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", action="append", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    records = []
    for cell in args.workload:
        for seed in args.seeds:
            rec = one(cell, seed, args.seconds, args.trace)
            records.append(rec)
            if args.out is not None:
                args.out.parent.mkdir(parents=True, exist_ok=True)
                with args.out.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
            res = rec["result"] or {}
            print(f"{cell} seed {seed}: rc {rec['rc']} wall {rec['wall_s']:.1f} s "
                  f"correct {res.get('correct')} "
                  f"{ {k: round(v['value'], 4) for k, v in res.get('metrics', {}).items()} } "
                  f"{ {k: v['value'] for k, v in res.get('checks', {}).items()} }", flush=True)
            if rec["rc"] != 0:
                print(rec["stderr_tail"][-1500:], flush=True)
    for line in summary(records):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
