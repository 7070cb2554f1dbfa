"""The benchmark's reading of a ``torch.profiler`` trace of a traced
window: every device activity with its interval, whether it is a kernel
launch, and the chain of host operations that launched it.

A ``--trace 1`` run records two windows of the same work: one of the device
alone (its busy time, launch counts and kernel times, at the window's own
pace) and one with the host's operations (which activities a convolution
launched, and what the host was doing in each idle gap; the profiler slows
the host there, so its idle time is not read).

The busy time is the union of the device activities' intervals (kernels,
copies and fills), so overlapping work counts once. A device activity is
tied to the innermost host operation that launched it by the profiler's
correlation id, and from there to its enclosing operations; where the
profiler gives no link, the chain is empty and a reader falls back on the
kernel's name.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType


@dataclasses.dataclass
class Activity:
    name: str
    start_us: float
    end_us: float
    kernel: bool          # a kernel launch, not a copy or a fill
    ops: Tuple[str, ...]  # launching host operations, innermost first

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) * 1e-6


@dataclasses.dataclass
class Trace:
    window_s: float
    activities: List[Activity]

    @property
    def kernels(self) -> List[Activity]:
        return [a for a in self.activities if a.kernel]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for a in sorted(self.activities, key=lambda a: a.start_us):
            if merged and a.start_us <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], a.end_us)
            else:
                merged.append([a.start_us, a.end_us])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_seconds(self, match: Callable[[Activity], bool]) -> float:
        return sum(a.seconds for a in self.activities if match(a))

    def top_ops(self, k: int = 10) -> List[list]:
        """The ``k`` device activities that took most time, summed by name."""
        sums: Dict[str, float] = {}
        for a in self.activities:
            sums[a.name] = sums.get(a.name, 0.0) + a.seconds
        return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The device's idle gaps summed by what the host was launching when
        the device went busy again (the innermost and the outermost host
        operation of the activity that ends the gap), the ``k`` longest."""
        starts = sorted(self.activities, key=lambda a: a.start_us)
        sums: Dict[str, float] = {}
        intervals = self.busy_intervals()
        j = 0
        for (_, end), (nxt, _) in zip(intervals, intervals[1:]):
            while starts[j].start_us < nxt:
                j += 1
            a = starts[j]
            label = (" < ".join(dict.fromkeys((a.ops[0], a.ops[-1]))) if a.ops
                     else f"(unlinked) {a.name}")
            sums[label] = sums.get(label, 0.0) + (nxt - end) * 1e-6
        return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:k]]


_NOT_LAUNCHES = ("memcpy", "memset")


def _host_chains(events) -> Dict[int, Tuple[str, ...]]:
    """Each host operation's chain of names, innermost first, by its
    correlation id: operations nest by their intervals on their thread."""
    ops: Dict[int, list] = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0 \
                and not e.is_async():
            ops.setdefault(e.start_thread_id(), []).append(e)
    chains: Dict[int, Tuple[str, ...]] = {}
    for thread_ops in ops.values():
        thread_ops.sort(key=lambda e: (e.start_ns(), -e.duration_ns()))
        stack: list = []  # (end_ns, chain)
        for e in thread_ops:
            while stack and stack[-1][0] <= e.start_ns():
                stack.pop()
            chain = (e.name(),) + (stack[-1][1] if stack else ())
            chains[e.correlation_id()] = chain[:16]
            stack.append((e.start_ns() + e.duration_ns(), chain))
    return chains


def record(run: Callable[[], int], host_ops: bool) -> Tuple[Trace, int]:
    """Run ``run`` (which returns the units of work it did) under the
    profiler, synchronised at both ends: ``(trace, units)``. With
    ``host_ops`` the host's operations are recorded too, which ties each
    device activity to its launching operations but slows the host; without
    them only the device's activities are, and the window keeps its pace.
    The profiler's raw events are read: a device activity's linked
    correlation id is its launching operation's correlation id."""
    from torch.profiler import ProfilerActivity, profile

    kinds = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=kinds) as prof:
        t0 = time.perf_counter()
        units = run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    chains = _host_chains(events) if host_ops else {}
    acts = []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        name = e.name()
        acts.append(Activity(name, e.start_ns() * 1e-3, (e.start_ns() + e.duration_ns()) * 1e-3,
                             not any(w in name.lower() for w in _NOT_LAUNCHES),
                             chains.get(e.linked_correlation_id(), ())))
    return Trace(window_s, acts), units
