"""Device kernel launches per served scene (copies and fills are not
launches): the cascade's dispatch from the host."""

LAYER = "cascade dispatch (cascade/upscale.py)"


def read(r):
    if r.unit != "scene" or r.units == 0:
        return None
    n = len(r.trace.kernels)
    return n / r.units if n else None
