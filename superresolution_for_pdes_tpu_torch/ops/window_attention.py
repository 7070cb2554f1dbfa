"""Window attention in token layout for SwinIR and HAT: hand-written CUDA
kernels (``csrc/window_attention.cu``) and their plain twins.

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

:func:`overlapping_window_attention` is HAT's overlapping cross-window
attention (OCAB): the queries of each ``window``-square window (not shifted)
attend to the keys and values of the ``key_window``-square window centred on
it (``(key_window - window) / 2`` wider on each side; upstream's
``nn.Unfold`` with zero padding over the map of k and v after the linear, so
a key outside the map is a zero vector whose logit is its bias alone), with
a ``(window + key_window - 1)^2``-row bias table indexed as upstream's
``calculate_rpi_oca`` (:func:`overlap_relative_index`) and no mask.

On CUDA, :func:`window_attention` runs the custom operators
``swinir::window_scaled_dot_product_attention`` and
``swinir::window_scaled_dot_product_attention_backward`` (the backward wired
through ``register_autograd``; the benchmark counts the window attention's
kernels by the ``scaled_dot_product`` in their launching operation's name)
inside a ``swinir.attention.kernel`` span, and
:func:`overlapping_window_attention` runs ``hat::overlapping_window_attention``
and its ``_backward`` (no ``scaled_dot_product`` in their names) inside a
``hat.ocab.kernel`` span. The kernels are built for the shapes of
:data:`KERNEL_SHAPES` (window 8 with heads of 30, SwinIR's published widths,
and window 4 with heads of 6, the tests' TINY widths: one block a window and
head) and of :data:`TILED_SHAPES` (window 16 with heads of 30, HAT's window
attention; windows of 16 with key windows of 24 and heads of 30, its
overlapping attention; and 4 with 6 and heads of 6, the latter's TINY
widths: key tiles with an online softmax; a shift a multiple of 4, as
window / 2 is), an even number of heads, and float32: bfloat16 or float16
inputs (the qkv linear's output under autocast) are widened to float32 for
them and the output is rounded back to the input's dtype; any other width or
dtype on CUDA raises. On the CPU each runs its plain twin
(:func:`plain_window_attention`,
:func:`plain_overlapping_window_attention`), the same arithmetic in PyTorch,
differentiated by autograd.

The wrappers count their launches in the kernels' one registry
(``ops/_build.py``): :func:`launch_counts` for the window attention's
(:func:`kernel_forward`, :func:`kernel_backward`),
:func:`overlap_launch_counts` for the overlapping attention's. A backward call
is two device launches on the window-8 pair (the kernel and the fixed-order
sum of the bias table's partials) and three on the tiled kernels (dQ, then dK
and dV with the bias partials, then their sum), four with an overlap (each
token's dK and dV summed over the key windows that hold it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from superresolution_for_pdes_tpu_torch.ops import _build
from superresolution_for_pdes_tpu_torch.ops._build import launch, ptr
from superresolution_for_pdes_tpu_torch.utils.profiling import span

KERNEL_SHAPES = frozenset({(8, 30), (4, 6)})  # (window, head size) of the window-8 pair
# (window, key window, head size) of the tiled kernels' instantiations
TILED_SHAPES = frozenset({(16, 16, 30), (16, 24, 30), (4, 6, 6)})
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


def overlap_relative_index(window: int, key_window: int, device=None) -> torch.Tensor:
    """``(window^2, key_window^2)`` row of the overlapping attention's bias
    table for each query and key: with ``(dr, dc)`` the key's place in its
    window minus the query's in its own and ``off = window - key_window + 1``,
    ``((dr + off)(window + key_window - 1) + dc + off)`` modulo the table's
    rows (upstream's ``calculate_rpi_oca``, whose negative indices wrap)."""
    side = window + key_window - 1
    off = window - key_window + 1
    i, j = torch.arange(window * window, device=device), torch.arange(key_window ** 2,
                                                                       device=device)
    dr = (j // key_window)[None, :] - (i // window)[:, None]
    dc = (j % key_window)[None, :] - (i % window)[:, None]
    return ((dr + off) * side + dc + off) % (side * side)


def plain_overlapping_window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                                       window: int, key_window: int,
                                       scale: float) -> torch.Tensor:
    """Plain PyTorch :func:`overlapping_window_attention`: ``(B, Hp, Wp, 3C)
    -> (B, Hp, Wp, C)``; the keys and values by ``F.unfold`` with zero
    padding."""
    b, hp, wp, c3 = qkv.shape
    c, nq, nk = c3 // 3, window * window, key_window * key_window
    d, rows, cols = c // heads, hp // window, wp // window
    q = qkv[..., :c].reshape(b, rows, window, cols, window, heads, d) \
        .permute(0, 1, 3, 5, 2, 4, 6).reshape(b, rows * cols, heads, nq, d)
    kv = F.unfold(qkv[..., c:].permute(0, 3, 1, 2), key_window,
                  padding=(key_window - window) // 2, stride=window)
    k, v = kv.view(b, 2, heads, d, nk, rows * cols).permute(1, 0, 5, 2, 4, 3).unbind(0)
    bias = table[overlap_relative_index(window, key_window, qkv.device)].permute(2, 0, 1)
    o = ((q @ k.transpose(-2, -1)) * scale + bias).softmax(-1) @ v
    return o.view(b, rows, cols, heads, window, window, d).permute(0, 1, 4, 2, 5, 3, 6) \
        .reshape(b, hp, wp, c)


# -------------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/window_attention.cu``'s library (built at the first call), its
    entry points' C signatures declared."""
    lib = _build.load_library("window_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i, i, i, i, i, i, i, f, p]  # batch, hp, wp, heads, window, head size, shift, scale
    lib.srpde_window_attention_forward.argtypes = [p] * 4 + dims
    lib.srpde_window_attention_backward.argtypes = [p] * 7 + dims
    tiled = [i, i, i, i, i, i, i, i, f, p]  # ... heads, window, key window, head size, ...
    lib.srpde_tiled_attention_forward.argtypes = [p] * 4 + tiled
    lib.srpde_tiled_attention_backward.argtypes = [p] * 10 + tiled
    lib.srpde_tiled_attention_key_tiles.argtypes = [i, i, i]
    for fn in (lib.srpde_window_attention_forward, lib.srpde_window_attention_backward,
               lib.srpde_tiled_attention_forward, lib.srpde_tiled_attention_backward,
               lib.srpde_tiled_attention_key_tiles):
        fn.restype = i
    return lib


def _dims(name: str, qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
          key_window: int, *others: torch.Tensor):
    """``(B, Hp, Wp, head size, windows)``, after checking what the kernels take."""
    if qkv.ndim != 4 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"{name}: qkv must be (B, Hp, Wp, 3 heads d), got {tuple(qkv.shape)} "
                         f"for {heads} heads")
    b, hp, wp, c3 = qkv.shape
    rows = (window + key_window - 1) ** 2
    if table.shape != (rows, heads):
        raise ValueError(f"{name}: the bias table is {tuple(table.shape)}, not {(rows, heads)}")
    for t in (qkv, table, *others):
        if t.device != qkv.device or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels take contiguous, 16-byte aligned float32 "
                             f"tensors on {qkv.device}")
    return b, hp, wp, c3 // (3 * heads), b * (hp // window) * (wp // window)


def _tiled(name: str, qkv, table, heads, window, key_window, *others):
    """:func:`_dims` and the tiled kernels' key tiles for this shape."""
    dims = _dims(name, qkv, table, heads, window, key_window, *others)
    return dims, _key_tiles(window, key_window, dims[3])


@functools.lru_cache(maxsize=None)
def _key_tiles(window: int, key_window: int, d: int) -> int:
    return _lib().srpde_tiled_attention_key_tiles(window, key_window, d)


def _tiled_forward(wrapper, qkv, table, heads, window, key_window, shift, scale):
    (b, hp, wp, d, windows), _ = _tiled(wrapper.__name__, qkv, table, heads, window, key_window)
    out = qkv.new_empty(b, hp, wp, heads * d)
    lse = qkv.new_empty(windows * heads, window * window)
    launch(wrapper, _lib().srpde_tiled_attention_forward, qkv, ptr(qkv), ptr(table), ptr(out),
           ptr(lse), b, hp, wp, heads, window, key_window, d, shift, scale)
    return out, lse


def _tiled_backward(wrapper, grad_out, qkv, out, lse, table, heads, window, key_window, shift,
                    scale):
    (b, hp, wp, d, windows), tiles = _tiled(wrapper.__name__, qkv, table, heads, window,
                                            key_window, grad_out, out, lse)
    dqkv = torch.empty_like(qkv)
    dtable = torch.empty_like(table)
    delta = torch.empty_like(lse)
    partial = qkv.new_empty(windows * max(tiles, 1), table.numel())
    kv_partial = (qkv.new_empty(windows, key_window * key_window, 2 * heads * d)
                  if key_window != window else None)
    launch(wrapper, _lib().srpde_tiled_attention_backward, qkv, ptr(grad_out), ptr(qkv), ptr(out),
           ptr(lse), ptr(table), ptr(dqkv), ptr(delta), ptr(kv_partial), ptr(partial),
           ptr(dtable), b, hp, wp, heads, window, key_window, d, shift, scale)
    return dqkv, dtable


def _paired(qkv: torch.Tensor, heads: int, window: int) -> bool:
    """Whether the window-8 pair (one block a window and head) takes this
    window, rather than the tiled kernels."""
    return (window, qkv.shape[-1] // (3 * heads)) in KERNEL_SHAPES


def kernel_forward(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int, shift: int,
                   scale: float):
    """One forward launch: ``(out (B, Hp, Wp, C), lse (windows heads, window^2))``."""
    if not _paired(qkv, heads, window):
        return _tiled_forward(kernel_forward, qkv, table, heads, window, window, shift, scale)
    b, hp, wp, d, windows = _dims("kernel_forward", qkv, table, heads, window, window)
    out = qkv.new_empty(b, hp, wp, heads * d)
    lse = qkv.new_empty(windows * heads, window * window)
    launch(kernel_forward, _lib().srpde_window_attention_forward, qkv,
           ptr(qkv), ptr(table), ptr(out), ptr(lse), b, hp, wp, heads, window, d, shift, scale)
    return out, lse


def kernel_backward(grad_out: torch.Tensor, qkv: torch.Tensor, out: Optional[torch.Tensor],
                    lse: torch.Tensor, table: torch.Tensor, heads: int, window: int, shift: int,
                    scale: float):
    """One backward call: ``(dqkv (B, Hp, Wp, 3C), dtable)``. The window-8
    pair recomputes the output's row sums and takes no ``out``; the tiled
    kernels read the forward's ``out``."""
    if not _paired(qkv, heads, window):
        return _tiled_backward(kernel_backward, grad_out, qkv, out, lse, table, heads, window,
                               window, shift, scale)
    b, hp, wp, d, windows = _dims("kernel_backward", qkv, table, heads, window, window,
                                  grad_out, lse)
    dqkv = torch.empty_like(qkv)
    dtable = torch.empty_like(table)
    partial = qkv.new_empty(windows, table.numel())
    launch(kernel_backward, _lib().srpde_window_attention_backward, qkv,
           ptr(grad_out), ptr(qkv), ptr(lse), ptr(table), ptr(dqkv), ptr(partial),
           ptr(dtable), b, hp, wp, heads, window, d, shift, scale)
    return dqkv, dtable


def overlap_kernel_forward(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                           key_window: int, scale: float):
    """One forward launch of the overlapping attention: ``(out, lse)``."""
    return _tiled_forward(overlap_kernel_forward, qkv, table, heads, window, key_window, 0, scale)


def overlap_kernel_backward(grad_out: torch.Tensor, qkv: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                            key_window: int, scale: float):
    """One backward call of the overlapping attention: ``(dqkv, dtable)``."""
    return _tiled_backward(overlap_kernel_backward, grad_out, qkv, out, lse, table, heads, window,
                           key_window, 0, scale)


KERNELS = (kernel_forward, kernel_backward)
OVERLAP_KERNELS = (overlap_kernel_forward, overlap_kernel_backward)
reset_launch_counts = functools.partial(_build.reset_launch_counts, KERNELS + OVERLAP_KERNELS)
launch_counts = functools.partial(_build.launch_counts, KERNELS)
overlap_launch_counts = functools.partial(_build.launch_counts, OVERLAP_KERNELS)


@torch.library.custom_op("swinir::window_scaled_dot_product_attention", mutates_args=(),
                         device_types="cuda")
def _attention_op(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int, shift: int,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return kernel_forward(qkv, table, heads, window, shift, scale)


@torch.library.custom_op("swinir::window_scaled_dot_product_attention_backward", mutates_args=(),
                         device_types="cuda")
def _attention_backward_op(grad_out: torch.Tensor, qkv: torch.Tensor, out: Optional[torch.Tensor],
                           lse: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                           shift: int, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return kernel_backward(grad_out, qkv, out, lse, table, heads, window, shift, scale)


def _setup_context(ctx, inputs, output):
    qkv, table, heads, window, *rest = inputs
    # the tiled kernels' backward reads the output (the proj linear keeps it anyway)
    ctx.save_for_backward(qkv, table, output[1],
                          None if _paired(qkv, heads, window) else output[0])
    ctx.args = (heads, window, *rest)
    ctx.set_materialize_grads(False)  # lse has no gradient


def _backward(ctx, grad_out, _grad_lse):
    qkv, table, lse, out = ctx.saved_tensors
    dqkv, dtable = _attention_backward_op(grad_out.contiguous(), qkv, out, lse, table, *ctx.args)
    return dqkv, dtable, None, None, None, None


torch.library.register_autograd("swinir::window_scaled_dot_product_attention", _backward,
                                setup_context=_setup_context)


@torch.library.custom_op("hat::overlapping_window_attention", mutates_args=(),
                         device_types="cuda")
def _overlap_op(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                key_window: int, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return overlap_kernel_forward(qkv, table, heads, window, key_window, scale)


@torch.library.custom_op("hat::overlapping_window_attention_backward", mutates_args=(),
                         device_types="cuda")
def _overlap_backward_op(grad_out: torch.Tensor, qkv: torch.Tensor, out: torch.Tensor,
                         lse: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                         key_window: int, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return overlap_kernel_backward(grad_out, qkv, out, lse, table, heads, window, key_window,
                                   scale)


def _overlap_setup_context(ctx, inputs, output):
    qkv, table, *args = inputs
    ctx.save_for_backward(qkv, table, output[0], output[1])
    ctx.args = args
    ctx.set_materialize_grads(False)


def _overlap_backward(ctx, grad_out, _grad_lse):
    qkv, table, out, lse = ctx.saved_tensors
    dqkv, dtable = _overlap_backward_op(grad_out.contiguous(), qkv, out, lse, table, *ctx.args)
    return dqkv, dtable, None, None, None, None


torch.library.register_autograd("hat::overlapping_window_attention", _overlap_backward,
                                setup_context=_overlap_setup_context)


# ------------------------------------------------------------------ dispatch
WIDENED = (torch.bfloat16, torch.float16)  # dtypes the kernels take widened to float32
_WINDOW_SHAPES = KERNEL_SHAPES | {(w, d) for w, kw, d in TILED_SHAPES if w == kw}
_OVERLAP_SHAPES = frozenset(s for s in TILED_SHAPES if s[1] > s[0])


def _check_dtypes(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32 and t.dtype not in WIDENED:
            raise TypeError(f"{name}: the CUDA kernels take float32, bfloat16 or "
                            f"float16, not {t.dtype}")


def _built_for(shapes, name: str, qkv: torch.Tensor, heads: int, *widths: int) -> None:
    d = qkv.shape[-1] // (3 * heads)
    if (*widths, d) not in shapes or heads % 2 or qkv.shape[-1] != 3 * heads * d:
        raise ValueError(f"{name}: no CUDA kernel for windows {widths} with {heads} heads of "
                         f"{qkv.shape[-1] / (3 * heads):g} (built for even head counts at "
                         f"{sorted(shapes)})")


def check_kernel_widths(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int) -> None:
    """Raise unless the kernels are built for these inputs: a (window, head
    size) of :data:`KERNEL_SHAPES` or a (window, window, head size) of
    :data:`TILED_SHAPES`, an even number of heads (so that every head's run of
    staged floats is 16-byte aligned and lies inside its token's row), and
    float32, or a dtype of :data:`WIDENED`."""
    _built_for(_WINDOW_SHAPES, "window_attention", qkv, heads, window)
    _check_dtypes("window_attention", qkv, table)


def check_overlap_widths(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                         key_window: int) -> None:
    """Raise unless the kernels are built for these inputs: a (window, key
    window, head size) of :data:`TILED_SHAPES` with a wider key window, an
    even number of heads, and float32 or a dtype of :data:`WIDENED`."""
    _built_for(_OVERLAP_SHAPES, "overlapping_window_attention", qkv, heads, window, key_window)
    _check_dtypes("overlapping_window_attention", qkv, table)


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


def overlapping_window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                                 window: int, key_window: int, scale: float) -> torch.Tensor:
    """``(B, Hp, Wp, 3C) -> (B, Hp, Wp, C)``: each window's queries attended to
    the keys of the wider window centred on it (module docstring)."""
    if qkv.device.type == "cpu":
        return plain_overlapping_window_attention(qkv, table, heads, window, key_window, scale)
    check_overlap_widths(qkv, table, heads, window, key_window)
    b, hp, wp, _ = qkv.shape
    with span("hat.ocab.kernel", b * (hp // window) * (wp // window) * heads):
        out = _overlap_op(qkv.float().contiguous(), table.float().contiguous(), heads, window,
                          key_window, float(scale))[0]
    return out.to(qkv.dtype)
