"""Share of the traced window in which no operation ran on the card, while
the cascade served scenes: the union of device activities against the
window's wall time."""

LAYER = "device"


def read(r):
    if r.unit != "step" or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
