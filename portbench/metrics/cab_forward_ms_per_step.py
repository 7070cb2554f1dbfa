"""Device milliseconds per train step of HAT's channel-attention blocks'
forward: the kernels launched inside the program's ``hat.cab`` spans (the
span's name in the launching chain: the two 3x3 convolutions, the GELU, the
pool, the squeeze's 1x1 convolutions, the sigmoid and the product), in the
traced window that records the host's operations.

Forward only: the backward's kernels run on the autograd engine's thread,
whose launching chains name the autograd nodes (``ConvolutionBackward0``,
...) and not the forward span, and the trace the benchmark keeps holds no
link from a node to the forward operation that made it; the same node names
serve the group's and the body's convolutions, so nothing in the chain tells
a CAB's backward from theirs. A program without the span gives nothing to
read."""

LAYER = "channel attention (models/hat.py; cuDNN convolutions)"


def is_cab(activity) -> bool:
    """A kernel launched inside a ``hat.cab`` span."""
    return activity.kernel and "hat.cab" in activity.ops


def read(r):
    if r.unit != "step" or r.ops_units == 0:
        return None
    ms = r.ops.device_seconds(is_cab) * 1e3
    return ms / r.ops_units if ms > 0 else None
