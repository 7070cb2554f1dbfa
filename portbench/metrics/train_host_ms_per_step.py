"""Host milliseconds inside the program's ``train.step`` spans per step: the
host's enqueue of a step (gather, forward, backward, clip, AdamW), in the
device-only window."""

from portbench.metrics._spans import host_ms_per_unit

LAYER = "train dispatch (train/loop.py)"


def read(r):
    if r.unit != "step":
        return None
    return host_ms_per_unit(r, "train.step")
