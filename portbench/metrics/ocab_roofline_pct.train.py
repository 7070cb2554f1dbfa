"""Share of its roofline that HAT's overlapping cross-window attention
reaches in a train step: the least time of its forward and backward
(``bound_s`` of the bytes and operations the model family's ``ocab_work``
counts) over the device time of its kernels (``ocab_ms_per_step``), in %.

The work is counted for the windows and heads the program attended: the sum
of ``n`` over its ``hat.ocab`` spans in the device-only window, a step, taken
as the batch whose passes attend that many. A program or family without them
gives nothing to read."""

from pathlib import Path

from portbench.harness import load_module
from portbench.metrics._spans import window_spans
from portbench.peaks import bound_s

LAYER = "overlapping cross-window attention (models/hat.py)"
_TIME = load_module(Path(__file__).with_name("ocab_ms_per_step.py"))


def read(r):
    work = getattr(r.family, "ocab_work", None)
    if r.unit != "step" or work is None or r.units == 0:
        return None
    spans = window_spans(r, "hat.ocab")
    ms = _TIME.read(r)
    if not spans or ms is None:
        return None
    arch, train = r.config["architecture"], r.config["train"]
    attended = sum(s.n for s in spans) / r.units
    batch = attended / r.family.ocab_window_heads(arch, 1, train["size"])
    nbytes, ops = work(arch, batch, train["size"])
    return 100.0 * bound_s(nbytes, ops, r.config["precision"]) / (ms * 1e-3)
