"""Device milliseconds of the model's convolutions per served scene: kernels
launched under a convolution operation or, where no ATen operation launched
them (a replayed CUDA graph's), named as cuDNN's convolution kernels
(``_kernels.is_convolution``), in the traced window that records the host's
operations."""

from portbench.metrics._kernels import is_convolution

LAYER = "models (models/unet.py, models/resnet.py; cuDNN convolutions)"


def read(r):
    if r.unit != "scene" or r.ops_units == 0:
        return None
    ms = r.ops.device_seconds(is_convolution) * 1e3
    return ms / r.ops_units if ms > 0 else None
