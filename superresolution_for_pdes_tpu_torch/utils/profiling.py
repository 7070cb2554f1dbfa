"""Tracing and timing (port of ``utils/profiling.py``).

:func:`device_trace` records a ``torch.profiler`` trace (CPU and, on a card,
CUDA activity) and writes it as a Chrome trace under ``log_dir``;
:func:`timed` and :func:`time_fn` are wall-clock timers, the latter
synchronizing the device of its outputs (JAX's ``block_until_ready``);
:class:`ThroughputCounter` accumulates items per second.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator

import torch

from superresolution_for_pdes_tpu_torch.device import resolve_device


@contextlib.contextmanager
def device_trace(log_dir: str | Path = "results/trace", device=None) -> Iterator[Path]:
    """Trace a block with ``torch.profiler`` on ``device`` (default ``cuda``:
    CPU and CUDA activity; ``cpu``: CPU activity only). Yields the path of the
    Chrome trace (``.json``) written under ``log_dir`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path = Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"
    with profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


@contextlib.contextmanager
def timed(result: Dict[str, float], key: str) -> Iterator[None]:
    """Wall-clock a block into ``result[key]`` (seconds). It synchronizes
    nothing: a block that launches device work should end in a
    synchronization."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        result[key] = time.perf_counter() - t0


def synchronize(out) -> None:
    """Wait for the device work behind every CUDA tensor in ``out`` (a tensor,
    or a tuple, list or dict of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for value in out.values():
            synchronize(value)
    elif isinstance(out, (list, tuple)):
        for value in out:
            synchronize(value)


def time_fn(fn, *args, reps: int = 10, warmup: int = 1, **kwargs) -> float:
    """Mean seconds per call of ``fn``, end to end (launches included), with
    the outputs' devices synchronized after the warm-up and after the reps."""
    for _ in range(warmup):
        synchronize(fn(*args, **kwargs))
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args, **kwargs)
    synchronize(out)
    return (time.perf_counter() - t0) / reps


@dataclass
class ThroughputCounter:
    """Accumulating items/sec counter (solves/sec, samples/sec, tiles/sec)."""

    items: int = 0
    seconds: float = 0.0
    _t0: float | None = field(default=None, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, items: int) -> None:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        self.seconds += time.perf_counter() - self._t0
        self.items += items
        self._t0 = None

    @property
    def per_second(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0
