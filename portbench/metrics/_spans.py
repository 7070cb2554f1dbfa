"""What the span readers share: the program's spans recorded in the
device-only window (``r.trace``), their host time, and the device's idle
time inside them.

The program records spans only while a profiler is open, so the buffer holds
those of the two traced windows, the device-only one first. The host-ops
window opens after a synchronise that follows the device-only window's last
activity: a span of the first window starts at or before that activity's
end, and a span of the second after it. A program without spans (no
``recorded_spans``, or an empty buffer) gives nothing to read.
"""

from __future__ import annotations

from typing import List, Tuple


def window_spans(r, name: str) -> list:
    """The program's spans named ``name`` in ``r.trace``'s window."""
    try:
        from superresolution_for_pdes_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return []
    if not r.trace.activities:
        return []
    end_ns = max(a.end_us for a in r.trace.activities) * 1e3
    return [s for s in recorded_spans() if s.name == name and s.start_ns <= end_ns]


def union(intervals) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _overlap(a, b) -> float:
    """Total length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_ms_per_unit(r, name: str):
    """Host milliseconds inside ``name``'s spans, per unit of work."""
    spans = window_spans(r, name)
    if not spans or r.units == 0:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6 / r.units


def idle_ms_per_unit(r, name: str):
    """Milliseconds per unit of work in which the device sat idle (between
    two of its busy intervals) while the host was inside a ``name`` span."""
    spans = window_spans(r, name)
    if not spans or r.units == 0:
        return None
    busy = r.trace.busy_intervals()
    gaps = [(end, nxt) for (_, end), (nxt, _) in zip(busy, busy[1:])]
    inside = union((s.start_ns * 1e-3, s.end_ns * 1e-3) for s in spans)
    return _overlap(gaps, inside) * 1e-3 / r.units
