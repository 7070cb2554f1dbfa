"""Host milliseconds inside the program's ``train.optimizer`` spans (AdamW's
``step``) per train step, in the device-only window."""

from portbench.metrics._spans import host_ms_per_unit

LAYER = "train dispatch (train/loop.py)"


def read(r):
    if r.unit != "step":
        return None
    return host_ms_per_unit(r, "train.optimizer")
