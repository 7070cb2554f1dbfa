"""Device milliseconds per served scene of Restormer's transposed attention
kernels (``csrc/transposed_attention.cu``: the Gram, softmax and apply
launches), found by the ``transposed_attention`` in their names in the
device-only window: they run inside replayed CUDA graphs, where no span opens
and no ATen operation launches them. The qkv and projection convolutions are
not counted. A program without those kernels gives nothing to read."""

LAYER = "transposed attention (models/restormer.py)"


def is_transposed_attention(activity) -> bool:
    return activity.kernel and "transposed_attention" in activity.name


def read(r):
    if r.unit != "scene" or r.units == 0:
        return None
    ms = r.trace.device_seconds(is_transposed_attention) * 1e3
    return ms / r.units if ms > 0 else None
