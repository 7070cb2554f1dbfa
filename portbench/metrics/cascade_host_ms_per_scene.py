"""Host milliseconds inside the program's ``cascade`` spans per served scene: the
host's enqueue of a scene, all its levels, in the device-only window."""

from portbench.metrics._spans import host_ms_per_unit

LAYER = "cascade dispatch (cascade/upscale.py)"


def read(r):
    if r.unit != "scene":
        return None
    return host_ms_per_unit(r, "cascade")
