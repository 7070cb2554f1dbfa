"""What the per-layer readers share: which device activities are
convolutions."""

from __future__ import annotations

# cuDNN's convolution kernels by name, for activities the profiler did not
# tie to a host operation (cf32: the complex products of FFT convolutions)
_CONV_NAMES = ("fprop", "dgrad", "wgrad", "conv", "fft", "winograd", "mult_and_sum", "cudnn",
               "cf32")


def is_convolution(activity) -> bool:
    """A kernel launched by a convolution's forward or backward, whatever
    library kernel implements it (its weight-gradient GEMMs included)."""
    if not activity.kernel:
        return False
    if activity.ops:
        return any("conv" in op.lower() for op in activity.ops)
    return any(k in activity.name.lower() for k in _CONV_NAMES)
