"""Share of the window attention's calls that ran the hand-written CUDA
kernel pair: the device-only window's ``swinir.attention`` spans that enclose
a ``swinir.attention.kernel`` span, in %. A program that recorded no
attention span gives nothing to read; one whose attention never opens a
kernel span reads 0."""

from portbench.metrics._spans import window_spans

LAYER = "window attention (models/swinir.py)"


def read(r):
    if r.unit != "step":
        return None
    calls = window_spans(r, "swinir.attention")
    if not calls:
        return None
    kernel = {s.parent for s in window_spans(r, "swinir.attention.kernel")}
    return 100.0 * sum(s.index in kernel for s in calls) / len(calls)
