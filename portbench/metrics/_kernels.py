"""What the per-layer readers share: which device activities are
convolutions."""

from __future__ import annotations

# cuDNN's convolution kernels by name: implicit-GEMM forward, data and weight
# gradients (also the older implicit_convolve_sgemm), Winograd, and the FFT
# convolution's transforms, pointwise complex products and complex (cf32)
# GEMMs. Not BatchNorm's cudnn::bn_*. A convolution's bias add is a plain
# elementwise kernel, which only its launching operation ties to it.
_CONV_NAMES = ("fprop", "dgrad", "wgrad", "convolve", "winograd", "fft", "mult_and_sum", "cf32")


def is_convolution(activity) -> bool:
    """A kernel launched by a convolution's forward or backward, whatever
    library kernel implements it (its weight-gradient GEMMs included): by
    its launching operations where an ATen operation launched it, and by its
    name where none did: a replayed CUDA graph's kernels are launched under
    the program's span ``cascade.replay``, or the profiler gave no link. Only
    the launching operation itself is asked, since the profiler's own
    events (``Buffer Flush``) can nest a replay's span inside the ATen copy
    before it."""
    if not activity.kernel:
        return False
    if activity.ops and activity.ops[0].startswith("aten::"):
        return any("conv" in op.lower() for op in activity.ops)
    return any(k in activity.name.lower() for k in _CONV_NAMES)
