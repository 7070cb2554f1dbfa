"""One run of one cell: resolve it by name, set up, measure, check, report.

Everything a cell needs is found by name under this folder:

- ``workloads/<cell>.json``: the configuration, the traffic mix, the why, and
  the limit of each number the comparison reads;
- ``configs/<config>.json``: the model's widths, precision and recipes;
- ``families/<family>.py``: the configuration's model family (its
  ``architecture.family``): the program's registry entry, the layout, the
  plain reference and the FLOPs;
- ``traffic/<traffic>.json``: the traffic's parameters and its ``driver``;
- ``drivers/<driver>.py``: ``setup``, ``window``, ``traced``, ``check``;
- ``metrics/<metric>.py``: a per-layer metric's ``read`` and ``LAYER``.

``BENCHMARK.json`` at the root of the checkout says which end-to-end metrics
(``--trace 0``) and per-layer metrics (``--trace 1``) a cell reports.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules a run may not hold once its window has closed, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "superresolution_for_pdes_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    spec: Dict[str, Any]   # the cell's own file
    driver: Any            # its driver module
    family: Any            # its configuration's model family module

    @property
    def limits(self) -> Dict[str, float]:
        return self.spec["limits"]


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the device's trace of a traced window
    and the units of work (scenes or steps) done in it, a second traced
    window of the same work with the host's operations (``ops``,
    ``ops_units``), and the cell's configuration, traffic and model family."""
    trace: Any
    units: int
    ops: Any
    ops_units: int
    unit: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    family: Any


class Phases:
    """Wall seconds of the phases of a set-up, for its log line."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def _json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise SystemExit(f"portbench: {path} not found")
    return json.loads(path.read_text())


def load_cell(name: str, base: Path = HERE) -> Cell:
    spec = _json(base / "workloads" / f"{name}.json")
    config = _json(base / "configs" / f"{spec['config']}.json")
    traffic = _json(base / "traffic" / f"{spec['traffic']}.json")
    driver = load_module(base / "drivers" / f"{traffic['driver']}.py")
    family = load_module(base / "families" / f"{config['architecture']['family']}.py")
    return Cell(name, config, traffic, spec, driver, family)


def load_module(path: Path):
    """A module from its file (metric files carry dots in their names)."""
    if not path.is_file():
        raise SystemExit(f"portbench: {path} not found")
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reported(benchmark: Dict[str, Any], cell: str, per_layer: bool) -> List[Dict[str, Any]]:
    """The metrics of ``BENCHMARK.json`` that ``cell`` reports."""
    e2e = [m for m in benchmark["end_to_end"] if cell in m.get("workloads", [cell])]
    if not per_layer:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in benchmark["per_layer"]
            if cell in m["workloads"] or ("workloads" not in m and m["moves"] in moved)]


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def use_checkout_caches() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    cell's first run there builds: the program's own nvcc builds already go
    to ``build/torch_kernels/``; Triton's, PyTorch extensions' and the CUDA
    driver's caches are set here, before the program could use them, since
    a later change to the program cannot edit the benchmark."""
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, device,
        benchmark: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Set up, measure, check. Returns the result line's object; the numbers
    compared, each with its limit, come last under ``checks``."""
    import torch

    cuda = device.type == "cuda"
    t_setup = time.perf_counter()
    state = cell.driver.setup(cell, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    phases = {"process start to set-up": t_setup - t_start, **state.get("phases", {})}
    print("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()), file=sys.stderr)
    metrics: Dict[str, Dict[str, Any]] = {}
    device_info: Dict[str, Any] = {}
    benchmark = benchmark if benchmark is not None else _json(ROOT / "BENCHMARK.json")
    if not trace:
        measured = cell.driver.window(state, seconds)
        measured["setup_s"] = setup_s
        attempted = measured.pop("attempted")
        for m in reported(benchmark, cell.name, per_layer=False):
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    else:
        from portbench import trace as tracing

        recorded, units = tracing.record(lambda: cell.driver.traced(state), host_ops=False)
        linked, linked_units = tracing.record(lambda: cell.driver.traced(state), host_ops=True)
        attempted = units + linked_units
        reading = Reading(recorded, units, linked, linked_units, cell.driver.UNIT, cell.config,
                          cell.traffic, cell.family)
        for m in reported(benchmark, cell.name, per_layer=True):
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=recorded.busy_s, window_s=recorded.window_s)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # the reference runs in float32 whatever the program set for its own run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = cell.driver.check(state)
    result = {
        "correct": all(checks[k] <= cell.limits[k] for k in cell.limits),
        "attempted": attempted,
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak, **device_info,
                   "card": _power_limit() if cuda else "none"},
    }
    if trace:
        result["breakdown"] = {"device_ops": recorded.top_ops(), "idle_gaps": linked.idle_gaps()}
    result["checks"] = {k: {"value": checks[k], "limit": cell.limits[k]} for k in cell.limits}
    return result
