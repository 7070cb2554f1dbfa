"""Device milliseconds per train step of the backward's column sums over
tokens and the LayerNorms' backward around them: the kernels that LayerNorm's
backward launches in full (an operation named ``native_layer_norm_backward``
in the launching chain: the input gradient, and the weight and bias gradients
where ATen computes them), the linears' bias sums that ``AddmmBackward0``
launches (``aten::sum`` in its chain) and the program's own token reductions
(an operation named ``swinir::token_``), in the traced window that records
the host's operations. The linears' GEMMs, convolutions (their bias sums too)
and the window attention are not counted."""

LAYER = "token reductions (models/swinir.py)"


def is_token_reduction(activity) -> bool:
    """A kernel of a LayerNorm's backward or of a linear's bias gradient."""
    if not activity.kernel:
        return False
    ops = [op.lower() for op in activity.ops]
    return any("native_layer_norm_backward" in op or op.startswith("swinir::token_")
               for op in ops) or ("aten::sum" in ops and any("addmmbackward" in op for op in ops))


def read(r):
    if r.unit != "step" or r.ops_units == 0:
        return None
    ms = r.ops.device_seconds(is_token_reduction) * 1e3
    return ms / r.ops_units if ms > 0 else None
