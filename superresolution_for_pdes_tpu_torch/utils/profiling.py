"""Tracing: the program's spans and a ``torch.profiler`` trace.

:func:`span` marks a phase of the program (a cascade level, a train step's
backward) as a context manager. It records only while a ``torch.profiler``
window is open: otherwise it hands back one shared no-op context, which
allocates nothing and reads no clock. Under a profiler a span opens a
record-function range of its name (``record_function``'s form written in C,
``_RecordFunctionFast``: a tenth of its cost, and its timestamps within a
microsecond of the span's own), so the profiler's own trace (and any Chrome
trace) shows the program's phases and ties each device activity launched
inside it to them, and appends a :class:`SpanRecord` to a bounded in-memory
buffer: its name, its start and end on ``time.time_ns()`` (the Unix-epoch
clock that the profiler's events carry too), its enclosing span, the
outermost span of its request or step, its thread, and a work count.
:func:`recorded_spans` reads the buffer, :func:`clear_spans` empties it; the
profiler's trace is the export.

Span names are fixed strings and never contain "conv": a reader that counts
a convolution's kernels by the names of their launching operations would
count a whole phase.

:func:`device_trace` records a ``torch.profiler`` trace (CPU and, on a card,
CUDA activity) and writes it as a Chrome trace under ``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from superresolution_for_pdes_tpu_torch.device import resolve_device, synchronize

SPAN_BUFFER = 65536  # records kept; the oldest go first


class SpanRecord(NamedTuple):
    """One closed span. ``index`` numbers spans in the order they opened;
    ``parent`` is the enclosing span's ``index`` (``None`` for an outermost
    span) and ``root`` the outermost span's, shared by every span of one
    request or step."""
    name: str
    start_ns: int
    end_ns: int
    index: int
    parent: Optional[int]
    root: int
    thread: int
    n: Optional[int]


_records: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_open = threading.local()  # .stack: this thread's open spans, outermost first
_numbers = itertools.count()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "n", "index", "parent", "root", "start_ns", "_range")

    def __init__(self, name: str, n: Optional[int]):
        self.name, self.n = name, n

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.index = next(_numbers)
        self.parent = stack[-1].index if stack else None
        self.root = stack[0].index if stack else self.index
        stack.append(self)
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self._range.__exit__(*exc)
        _open.stack.pop()
        _records.append(SpanRecord(self.name, self.start_ns, end_ns, self.index, self.parent,
                                   self.root, threading.get_ident(), self.n))
        return False


def span(name: str, n: Optional[int] = None):
    """A context manager marking the phase ``name`` (with a work count ``n``)
    while a ``torch.profiler`` window is open; a shared no-op otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, n)


def recorded_spans() -> List[SpanRecord]:
    """The closed spans in the buffer, in the order they closed (a child
    before its parent)."""
    return list(_records)


def clear_spans() -> None:
    _records.clear()


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
        synchronize(dev)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
