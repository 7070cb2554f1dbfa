"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), the yardstick of every share of a peak or
a roofline the benchmark reports."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def bound_s(bytes_moved: float, flops: float, precision: str = "float32") -> float:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the peak of ``precision``."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FLOPS_PER_S[precision])
