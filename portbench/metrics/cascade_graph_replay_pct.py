"""Share of the served scenes' cascade levels that the program replayed as a
CUDA graph: the device-only window's ``cascade.level`` spans that enclose a
``cascade.replay`` span, in %. A program that cannot replay a level (no
``cascade/graphs.py``) or that recorded no level span gives nothing to read."""

from portbench.metrics._spans import window_spans

LAYER = "cascade dispatch (cascade/upscale.py)"


def read(r):
    if r.unit != "scene":
        return None
    try:
        from superresolution_for_pdes_tpu_torch.cascade import graphs  # noqa: F401
    except ImportError:
        return None
    levels = window_spans(r, "cascade.level")
    if not levels:
        return None
    replayed = {s.parent for s in window_spans(r, "cascade.replay")}
    return 100.0 * sum(s.index in replayed for s in levels) / len(levels)
