"""SwinIR's shifted-window attention in token layout: a hand-written CUDA
kernel pair (``csrc/window_attention.cu``) and its plain twin.

:func:`window_attention` takes the qkv linear's output on the map as it is,
``(B, Hp, Wp, 3C)`` (q, k, v of every token, ``heads`` heads of ``C / heads``
inside each), and returns the attended tokens ``(B, Hp, Wp, C)`` in the same
places, ready for the proj linear. The window ``(wr, wc)`` of the map rolled
by ``-shift`` holds the tokens at ``((wr ws + i + shift) mod Hp, (wc ws + j +
shift) mod Wp)``; each window and head attends with
``softmax(scale q k^T + table[index] (+ mask)) v``, the mask being upstream's
-100 between tokens of different regions of the rolled map (shifted blocks
only). So the roll, the window partition, the reverse and the roll back of
upstream's block are index arithmetic, and the region mask comes from a
token's place in the map.

On CUDA it runs the custom operators
``swinir::window_scaled_dot_product_attention`` and
``swinir::window_scaled_dot_product_attention_backward`` (the backward wired
through ``register_autograd``; the benchmark counts the attention's kernels
by the ``scaled_dot_product`` in their launching operation's name) inside a
``swinir.attention.kernel`` span. The kernels are built for the shapes of
:data:`KERNEL_SHAPES` (window 8 with heads of 30, SwinIR's published widths,
and window 4 with heads of 6, the tests' TINY widths), an even number of
heads, and float32: bfloat16 or float16 inputs (the qkv linear's output
under autocast) are widened to float32 for them and the output is rounded
back to the input's dtype; any other width or dtype on CUDA raises. On the
CPU it runs :func:`plain_window_attention`, the same arithmetic in PyTorch (a
gather at the windows' token positions, matmuls, bias, mask, softmax, the
inverse gather), differentiated by autograd.

The launches are counted in ``.launches`` on :func:`kernel_forward` and
:func:`kernel_backward` (a backward call is two device launches: the kernel
and the fixed-order sum of the bias table's partials).
"""

from __future__ import annotations

import ctypes
import functools
import torch

from superresolution_for_pdes_tpu_torch.ops.stencil_kernels import _on, _ptr, _raise_on, _stream
from superresolution_for_pdes_tpu_torch.utils.profiling import span

KERNEL_SHAPES = frozenset({(8, 30), (4, 6)})  # (window, head size) of the kernels' instantiations
MASK = -100.0  # upstream's logit between tokens of different shift regions


# ----------------------------------------------------------------- plain twin
def _partition(grid: torch.Tensor, window: int) -> torch.Tensor:
    """``(Hp, Wp) -> (windows, window^2)``, windows and their tokens row-major."""
    hp, wp = grid.shape
    return grid.view(hp // window, window, wp // window, window).permute(0, 2, 1, 3) \
        .reshape(-1, window * window)


def window_positions(hp: int, wp: int, window: int, shift: int, device) -> torch.Tensor:
    """``(windows, window^2)``: the flat map position of each token of each
    window of the map rolled by ``-shift``."""
    rows = (torch.arange(hp, device=device) + shift) % hp
    cols = (torch.arange(wp, device=device) + shift) % wp
    return _partition(rows[:, None] * wp + cols[None, :], window)


def relative_position_index(window: int, device=None) -> torch.Tensor:
    """``(window^2, window^2)`` row of the bias table for each pair of window
    tokens: ``(di + ws - 1)(2 ws - 1) + (dj + ws - 1)``."""
    i = torch.arange(window * window, device=device)
    r, c = i // window, i % window
    return (r[:, None] - r[None, :] + window - 1) * (2 * window - 1) + (c[:, None] - c[None, :]
                                                                       + window - 1)


def region_mask(hp: int, wp: int, window: int, shift: int, device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(windows, window^2, window^2)`` region mask of the map rolled by
    ``-shift``: 0 within a region of its 3x3 slicing by ``(-window, -shift)``,
    -100 across."""

    def regions(n):
        i = torch.arange(n, device=device)
        return (i >= n - window).long() + (i >= n - shift).long()

    ids = _partition(regions(hp)[:, None] * 3 + regions(wp)[None, :], window)
    across = ids[:, None, :] != ids[:, :, None]
    return torch.zeros(across.shape, dtype=dtype, device=device).masked_fill_(across, MASK)


def plain_window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                           shift: int, scale: float) -> torch.Tensor:
    """Plain PyTorch :func:`window_attention`: ``(B, Hp, Wp, 3C) -> (B, Hp, Wp, C)``."""
    b, hp, wp, c3 = qkv.shape
    c, n = c3 // 3, window * window
    d = c // heads
    pos = window_positions(hp, wp, window, shift, qkv.device).flatten()
    nw = pos.numel() // n
    x = qkv.reshape(b, hp * wp, 3, heads, d)[:, pos].view(b, nw, n, 3, heads, d)
    q, k, v = x.permute(3, 0, 1, 4, 2, 5).unbind(0)  # (B, windows, heads, n, d)
    bias = table[relative_position_index(window, qkv.device)].permute(2, 0, 1)
    logits = (q @ k.transpose(-2, -1)) * scale + bias
    if shift:
        logits = logits + region_mask(hp, wp, window, shift, qkv.device, logits.dtype)[:, None]
    o = (logits.softmax(-1) @ v).permute(0, 1, 3, 2, 4).reshape(b, nw * n, c)
    inverse = torch.empty_like(pos).scatter_(0, pos, torch.arange(pos.numel(), device=pos.device))
    return o[:, inverse].view(b, hp, wp, c)


# -------------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/window_attention.cu``'s library (built at the first call), its
    entry points' C signatures declared."""
    from superresolution_for_pdes_tpu_torch.ops._build import load_library

    lib = load_library("window_attention")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i, i, i, i, i, i, i, f, ptr]  # batch, hp, wp, heads, window, head size, shift, scale
    lib.srpde_window_attention_forward.argtypes = [ptr] * 4 + dims
    lib.srpde_window_attention_backward.argtypes = [ptr] * 7 + dims
    for fn in (lib.srpde_window_attention_forward, lib.srpde_window_attention_backward):
        fn.restype = i
    return lib


def _dims(name: str, qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
          *others: torch.Tensor):
    """``(B, Hp, Wp, head size, windows)``, after checking what the kernels take."""
    if qkv.ndim != 4 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"{name}: qkv must be (B, Hp, Wp, 3 heads d), got {tuple(qkv.shape)} "
                         f"for {heads} heads")
    b, hp, wp, c3 = qkv.shape
    if table.shape != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"{name}: the bias table is {tuple(table.shape)}, not "
                         f"{((2 * window - 1) ** 2, heads)}")
    for t in (qkv, table, *others):
        if t.device != qkv.device or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels take contiguous, 16-byte aligned float32 "
                             f"tensors on {qkv.device}")
    return b, hp, wp, c3 // (3 * heads), b * (hp // window) * (wp // window)


def kernel_forward(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int, shift: int,
                   scale: float):
    """One forward launch: ``(out (B, Hp, Wp, C), lse (windows heads, window^2))``."""
    name = "kernel_forward"
    b, hp, wp, d, windows = _dims(name, qkv, table, heads, window)
    out = qkv.new_empty(b, hp, wp, heads * d)
    lse = qkv.new_empty(windows * heads, window * window)
    with _on(qkv):
        code = _lib().srpde_window_attention_forward(
            _ptr(qkv), _ptr(table), _ptr(out), _ptr(lse), b, hp, wp, heads, window, d, shift,
            scale, _stream(qkv))
    _raise_on(f"window attention {name}", code)
    kernel_forward.launches += 1
    return out, lse


def kernel_backward(grad_out: torch.Tensor, qkv: torch.Tensor, lse: torch.Tensor,
                    table: torch.Tensor, heads: int, window: int, shift: int, scale: float):
    """One backward call (the kernel, then the sum of its bias partials):
    ``(dqkv (B, Hp, Wp, 3C), dtable)``."""
    name = "kernel_backward"
    b, hp, wp, d, windows = _dims(name, qkv, table, heads, window, grad_out, lse)
    dqkv = torch.empty_like(qkv)
    dtable = torch.empty_like(table)
    partial = qkv.new_empty(windows, table.numel())
    with _on(qkv):
        code = _lib().srpde_window_attention_backward(
            _ptr(grad_out), _ptr(qkv), _ptr(lse), _ptr(table), _ptr(dqkv), _ptr(partial),
            _ptr(dtable), b, hp, wp, heads, window, d, shift, scale, _stream(qkv))
    _raise_on(f"window attention {name}", code)
    kernel_backward.launches += 1
    return dqkv, dtable


def reset_launch_counts() -> None:
    kernel_forward.launches = kernel_backward.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in (kernel_forward, kernel_backward)}


reset_launch_counts()


@torch.library.custom_op("swinir::window_scaled_dot_product_attention", mutates_args=(),
                         device_types="cuda")
def _attention_op(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int, shift: int,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return kernel_forward(qkv, table, heads, window, shift, scale)


@torch.library.custom_op("swinir::window_scaled_dot_product_attention_backward", mutates_args=(),
                         device_types="cuda")
def _attention_backward_op(grad_out: torch.Tensor, qkv: torch.Tensor, lse: torch.Tensor,
                           table: torch.Tensor, heads: int, window: int, shift: int,
                           scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return kernel_backward(grad_out, qkv, lse, table, heads, window, shift, scale)


def _setup_context(ctx, inputs, output):
    qkv, table, *args = inputs
    ctx.save_for_backward(qkv, table, output[1])
    ctx.args = args
    ctx.set_materialize_grads(False)  # lse has no gradient


def _backward(ctx, grad_out, _grad_lse):
    qkv, table, lse = ctx.saved_tensors
    dqkv, dtable = _attention_backward_op(grad_out.contiguous(), qkv, lse, table, *ctx.args)
    return dqkv, dtable, None, None, None, None


torch.library.register_autograd("swinir::window_scaled_dot_product_attention", _backward,
                                setup_context=_setup_context)


# ------------------------------------------------------------------ dispatch
WIDENED = (torch.bfloat16, torch.float16)  # dtypes the kernels take widened to float32


def check_kernel_widths(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int) -> None:
    """Raise unless the kernels are built for these inputs: a (window, head
    size) of :data:`KERNEL_SHAPES`, an even number of heads (so that every
    head's run of staged floats is 16-byte aligned and lies inside its
    token's row), and float32, or a dtype of :data:`WIDENED`."""
    d = qkv.shape[-1] // (3 * heads)
    if (window, d) not in KERNEL_SHAPES or heads % 2 or qkv.shape[-1] != 3 * heads * d:
        raise ValueError(f"window_attention: no CUDA kernel for window {window} with {heads} "
                         f"heads of {qkv.shape[-1] / (3 * heads):g} (built for even head counts "
                         f"at (window, head size) in {sorted(KERNEL_SHAPES)})")
    for t in (qkv, table):
        if t.dtype != torch.float32 and t.dtype not in WIDENED:
            raise TypeError(f"window_attention: the CUDA kernels take float32, bfloat16 or "
                            f"float16, not {t.dtype}")


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                     shift: int, scale: float) -> torch.Tensor:
    """``(B, Hp, Wp, 3C) -> (B, Hp, Wp, C)``: each window of the map rolled by
    ``-shift`` attended per head, written back in place (module docstring)."""
    if qkv.device.type == "cpu":
        return plain_window_attention(qkv, table, heads, window, shift, scale)
    check_kernel_widths(qkv, table, heads, window)
    b, hp, wp, _ = qkv.shape
    with span("swinir.attention.kernel", b * (hp // window) * (wp // window) * heads):
        out = _attention_op(qkv.float().contiguous(), table.float().contiguous(), heads, window,
                            shift, float(scale))[0]
    return out.to(qkv.dtype)
