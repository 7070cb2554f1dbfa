"""Device milliseconds per train step of HAT's overlapping cross-window
attention kernels, forward and backward: the kernels launched under the
program's ``hat::overlapping_window_attention`` operations (an operation of
that name, or its ``_backward``, in the launching chain), in the traced window
that records the host's operations. The qkv and proj layers, the MLP and the
HABs' window attention (``attention_ms_per_step``) are not counted. A program
without those operations gives nothing to read."""

LAYER = "overlapping cross-window attention (models/hat.py)"


def is_ocab(activity) -> bool:
    """A kernel that the overlapping attention's operations launched."""
    return activity.kernel and any(op.startswith("hat::overlapping_window_attention")
                                   for op in activity.ops)


def read(r):
    if r.unit != "step" or r.ops_units == 0:
        return None
    ms = r.ops.device_seconds(is_ocab) * 1e3
    return ms / r.ops_units if ms > 0 else None
