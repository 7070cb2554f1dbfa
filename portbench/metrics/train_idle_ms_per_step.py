"""Device idle milliseconds per step while the host was inside a
``train.step`` span: the part of ``device_idle_pct.train`` the steps leave."""

from portbench.metrics._spans import idle_ms_per_unit

LAYER = "device"


def read(r):
    if r.unit != "step":
        return None
    return idle_ms_per_unit(r, "train.step")
