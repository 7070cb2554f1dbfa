"""Share of the backward's LayerNorm and linear column sums over tokens that
ran on the program's hand-written reduction, in %: its kernels launched under
an operation named ``swinir::token_`` (one ``token_reduce_kernel`` a call),
against those and ATen's (a ``GammaBeta`` kernel under
``native_layer_norm_backward``, a kernel of ``aten::sum`` under
``AddmmBackward0``), in the traced window that records the host's operations.
A step with none of them gives nothing to read."""

LAYER = "token reductions (models/swinir.py)"


def _count(r, match) -> int:
    return sum(1 for a in r.ops.activities if a.kernel and match(a, [op.lower() for op in a.ops]))


def _kernel(a, ops) -> bool:
    return "token_reduce_kernel" in a.name and any(op.startswith("swinir::token_") for op in ops)


def _aten(a, ops) -> bool:
    norm = "GammaBeta" in a.name and any("native_layer_norm_backward" in op for op in ops)
    return norm or ("aten::sum" in ops and any("addmmbackward" in op for op in ops))


def read(r):
    if r.unit != "step":
        return None
    kernel, aten = _count(r, _kernel), _count(r, _aten)
    return 100.0 * kernel / (kernel + aten) if kernel + aten else None
