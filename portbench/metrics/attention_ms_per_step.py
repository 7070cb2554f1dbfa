"""Device milliseconds per train step of the window attention's fused
kernels, forward and backward: the kernels that ``F.scaled_dot_product_attention``
and its backward launch (an ATen operation named ``scaled_dot_product`` in
the launching chain), in the traced window that records the host's
operations. The qkv and proj layers, the windows' reshapes and the bias
gather are not counted."""

LAYER = "window attention (models/swinir.py)"


def is_attention(activity) -> bool:
    """A kernel that a scaled-dot-product attention operation or its
    backward launched."""
    return activity.kernel and any("scaled_dot_product" in op.lower() for op in activity.ops)


def read(r):
    if r.unit != "step" or r.ops_units == 0:
        return None
    ms = r.ops.device_seconds(is_attention) * 1e3
    return ms / r.ops_units if ms > 0 else None
