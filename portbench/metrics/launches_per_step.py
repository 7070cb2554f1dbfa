"""Device kernel launches per train step (copies and fills are not
launches): the training loop's dispatch from the host."""

LAYER = "train dispatch (train/loop.py)"


def read(r):
    if r.unit != "step" or r.units == 0:
        return None
    n = len(r.trace.kernels)
    return n / r.units if n else None
