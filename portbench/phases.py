"""Where a cell's time goes, by the program's spans: one traced window of
the cell's work (the device alone, at the window's own pace, as
``--trace 1``'s first window), and for each span, by name and cascade level,
its host milliseconds, the device milliseconds of the activities launched
inside it, and the device's idle milliseconds inside it, per unit of work
(scene or step).

    python3 portbench/phases.py --workload <cell> --seed <n> [--out phases.json]

From the root of a checkout, on a card. Prints a Markdown table; ``--out``
writes the rows as JSON. Each device activity is put down to the innermost
span open when the host launched it: the CUDA runtime call that launched it
shares its correlation id, and carries the host time and thread of the
launch. A launch from a thread that holds no open span (autograd's, which
runs backward) goes to the innermost span open on the thread that does. The
columns of a span include its children's.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.metrics._spans import union  # noqa: E402


class Launched(NamedTuple):
    """A device activity with the host time (ns) and thread of its launch."""
    start_us: float
    end_us: float
    launch_ns: int
    thread: int


class Row(NamedTuple):
    name: str
    level: Optional[int]  # the output resolution of the cascade level it is in
    calls: float          # per unit
    host_ms: float
    device_ms: float
    idle_ms: float


def _level_of(span, by_index) -> Optional[int]:
    s = span
    while s is not None:
        if s.name == "cascade.level":
            return s.n
        s = by_index.get(s.parent)
    return None


def _gaps(activities: Sequence[Launched]) -> List[Tuple[float, float]]:
    busy = union((a.start_us, a.end_us) for a in activities)
    return [(e, s) for (_, e), (s, _) in zip(busy, busy[1:])]


def _idle_us(gaps, starts, lo: float, hi: float) -> float:
    total, i = 0.0, max(0, bisect.bisect_right(starts, lo) - 1)
    while i < len(gaps) and gaps[i][0] < hi:
        total += max(0.0, min(hi, gaps[i][1]) - max(lo, gaps[i][0]))
        i += 1
    return total


def table(activities: Sequence[Launched], spans: Sequence, units: int) -> Tuple[List[Row], float]:
    """Rows by (span name, cascade level), in the order each first opens, and
    the device milliseconds per unit launched outside every span."""
    by_index = {s.index: s for s in spans}
    groups: Dict[int, list] = {}
    for s in spans:
        groups.setdefault(s.root, []).append(s)
    roots = sorted((by_index[r] for r in groups if r in by_index), key=lambda s: s.start_ns)
    root_starts = [r.start_ns for r in roots]
    threads = {s.thread for s in spans}
    device_us: Dict[int, float] = {s.index: 0.0 for s in spans}
    outside_us = 0.0
    for a in activities:
        i = bisect.bisect_right(root_starts, a.launch_ns) - 1
        inner = None
        if i >= 0 and a.launch_ns <= roots[i].end_ns:
            open_ = [s for s in groups[roots[i].index] if s.start_ns <= a.launch_ns <= s.end_ns]
            own = [s for s in open_ if s.thread == a.thread] or (
                open_ if a.thread not in threads else [])
            inner = max(own, key=lambda s: s.start_ns, default=None)
        if inner is None:
            outside_us += a.end_us - a.start_us
            continue
        s = inner
        while s is not None:  # a span's device time includes its children's
            device_us[s.index] += a.end_us - a.start_us
            s = by_index.get(s.parent)
    gaps = _gaps(activities)
    gap_starts = [g[0] for g in gaps]
    sums: Dict[Tuple[str, Optional[int]], List[float]] = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        key = (s.name, _level_of(s, by_index))
        acc = sums.setdefault(key, [0.0, 0.0, 0.0, 0.0])
        acc[0] += 1
        acc[1] += (s.end_ns - s.start_ns) * 1e-6
        acc[2] += device_us[s.index] * 1e-3
        acc[3] += _idle_us(gaps, gap_starts, s.start_ns * 1e-3, s.end_ns * 1e-3) * 1e-3
    rows = [Row(name, level, *(v / units for v in acc)) for (name, level), acc in sums.items()]
    return rows, outside_us * 1e-3 / units


def launched(events) -> List[Launched]:
    """The device activities of a CUDA-only profile, each with the host time
    and thread of the runtime call that launched it (matched by correlation
    id); an activity with no such call keeps its own start as its launch."""
    from torch.autograd import DeviceType

    calls = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.correlation_id():
            calls[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    out = []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        start = e.start_ns()
        launch, thread = calls.get(e.correlation_id(), (start, 0))
        out.append(Launched(start * 1e-3, (start + e.duration_ns()) * 1e-3, launch, thread))
    return out


def markdown(cell: str, rows: List[Row], outside_ms: float, unit: str, window_ms: float,
             busy_ms: float) -> str:
    lines = [f"{cell}: per {unit}, window {window_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
             f"launched outside every span {outside_ms:.3f} ms",
             "", "| Span | Level | Calls | Host ms | Device ms | Idle ms |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| `{r.name}` | {r.level or ''} | {r.calls:g} | {r.host_ms:.3f} | "
                     f"{r.device_ms:.3f} | {r.idle_ms:.3f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpus[len(cpus) // 2:])  # as run.py

    from portbench import harness

    harness.use_checkout_caches()
    cell = harness.load_cell(args.workload)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from superresolution_for_pdes_tpu_torch.utils.profiling import clear_spans, recorded_spans

    if not torch.cuda.is_available():
        print("portbench: phases needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = cell.driver.setup(cell, args.seed, torch.device("cuda", 0))
    torch.cuda.synchronize()
    clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = cell.driver.traced(state)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    acts = launched(prof.profiler.kineto_results.events())
    rows, outside = table(acts, recorded_spans(), units)
    busy = sum(e - s for s, e in union((a.start_us, a.end_us) for a in acts))
    print(markdown(cell.name, rows, outside, cell.driver.UNIT, window_s * 1e3 / units,
                   busy * 1e-3 / units))
    if args.out:
        Path(args.out).write_text(json.dumps({"cell": cell.name, "seed": args.seed,
                                              "units": units, "window_s": window_s,
                                              "outside_ms": outside,
                                              "rows": [r._asdict() for r in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
