"""SwinIR's backward column sums over tokens: a hand-written CUDA reduction
(``csrc/token_reduce.cu``) and its plain twin, and the linear and LayerNorm
that take their parameter gradients from it.

:func:`bias_grad` sums a row-major ``(M, C)`` gradient over its ``M`` token
rows, which is a linear's bias gradient; :func:`layer_norm_affine_grad`
gives a LayerNorm's weight and bias gradients, ``(sum_r g (x - mean) rstd,
sum_r g)``, from its output gradient, its input and its forward's per-token
``mean`` and ``rstd``. Both accumulate in float32 (float64 stays float64 on
the CPU) and return float32, which autograd rounds to the parameter's dtype
(a bfloat16 bias under autocast).

On CUDA they run the custom operators ``swinir::token_bias_grad`` and
``swinir::token_layer_norm_affine_grad`` (the benchmark counts their kernels
by the ``swinir::token_`` of their launching operation's name): one kernel
that streams whole rows and writes a partial row a block, and a second launch
that adds the partials in a fixed order, so a run gives the same bits every
time. They take float32 or bfloat16, a width ``C`` that is a multiple of 4 up
to 4,096, contiguous 16-byte aligned tensors (8-byte for bfloat16) and
float32 statistics; anything else on CUDA raises. On the CPU they run the
plain twins :func:`plain_bias_grad` and :func:`plain_layer_norm_affine_grad`.

:func:`linear` and :func:`layer_norm` are ``F.linear`` and ``F.layer_norm``
whose backward takes the bias (and LayerNorm weight) gradient from these
sums. Their forward is the same ATen call (``F.linear``,
``torch.native_layer_norm``) and their backward issues ATen's own calls for
everything else: the linear's input and weight gradients are the two ``mm``
of ``AddmmBackward0``, LayerNorm's input gradient is
``native_layer_norm_backward`` asked for that alone. Under autocast the
inputs are cast as autocast casts them for the ATen op (lower precision for
the linear; float32 for LayerNorm on CUDA, as they come on the CPU), so
every gradient keeps the dtype and the
bits it had, the sums aside. Without a gradient to take they call
``F.linear`` and ``F.layer_norm``.

:func:`kernel_bias_grad` and :func:`kernel_layer_norm_affine_grad` count
their calls in the kernels' one launch registry (``ops/_build.py``;
:func:`launch_counts`); a call is two device launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from superresolution_for_pdes_tpu_torch.ops import _build
from superresolution_for_pdes_tpu_torch.ops._build import launch, ptr

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
VEC = 4             # columns a thread of the kernel reads at once
MAX_COLUMNS = 4096  # VEC x the kernel's most threads a row
MAX_BLOCKS = 1024   # rows of the partials' scratch: the kernel's most blocks


# ----------------------------------------------------------------- plain twins
def _accumulator(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def plain_bias_grad(g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`bias_grad`: ``(M, C) -> (C,)``."""
    return g.sum(0, dtype=_accumulator(g.dtype))


def plain_layer_norm_affine_grad(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                                 rstd: torch.Tensor):
    """Plain PyTorch :func:`layer_norm_affine_grad`: ``(weight, bias)`` gradients, ``(C,)`` each."""
    acc = _accumulator(g.dtype)
    g = g.to(acc)
    xhat = (x.to(acc) - mean.to(acc)[:, None]) * rstd.to(acc)[:, None]
    return (g * xhat).sum(0), g.sum(0)


# -------------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/token_reduce.cu``'s library (built at the first call), its entry
    points' C signatures declared."""
    lib = _build.load_library("token_reduce")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.srpde_token_bias_grad.argtypes = [p, ll, i, i, p, i, p, p]
    lib.srpde_token_layer_norm_affine_grad.argtypes = [p, p, p, p, ll, i, i, p, i, p, p, p]
    for fn in (lib.srpde_token_bias_grad, lib.srpde_token_layer_norm_affine_grad):
        fn.restype = i
    return lib


def check_kernel_widths(g: torch.Tensor, x: Optional[torch.Tensor] = None,
                        mean: Optional[torch.Tensor] = None,
                        rstd: Optional[torch.Tensor] = None) -> None:
    """Raise unless the kernel takes these inputs: ``g`` (and ``x``, of its
    shape and dtype) a contiguous ``(M, C)`` float32 or bfloat16 tensor with
    ``C`` a multiple of 4 up to 4,096, 16-byte aligned (8-byte for bfloat16),
    and ``mean`` and ``rstd`` contiguous float32 ``(M,)``, all on ``g``'s device."""
    name = "token_reduce"
    if g.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, not {g.dtype}")
    if g.ndim != 2 or g.shape[1] % VEC or not 0 < g.shape[1] <= MAX_COLUMNS:
        raise ValueError(f"{name}: no CUDA kernel for a gradient of {tuple(g.shape)} (built for "
                         f"(tokens, C) with C a multiple of {VEC} up to {MAX_COLUMNS})")
    align = VEC * g.element_size()
    rows = [g] if x is None else [g, x]
    if x is not None and (x.shape != g.shape or x.dtype != g.dtype):
        raise ValueError(f"{name}: the input is {x.dtype} {tuple(x.shape)}, the gradient "
                         f"{g.dtype} {tuple(g.shape)}")
    for t in rows:
        if t.device != g.device or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name}: the kernel takes contiguous, {align}-byte aligned rows on "
                             f"{g.device}")
    for t in () if x is None else (mean, rstd):
        if t.device != g.device or t.dtype != torch.float32 or t.shape != g.shape[:1] \
                or not t.is_contiguous():
            raise ValueError(f"{name}: the statistics must be contiguous float32 "
                             f"({g.shape[0]},) on {g.device}")


def kernel_bias_grad(g: torch.Tensor) -> torch.Tensor:
    """One call (the kernel, then the sum of its partials): ``(C,)`` float32."""
    check_kernel_widths(g)
    rows, cols = g.shape
    partial = g.new_empty(MAX_BLOCKS, cols, dtype=torch.float32)
    out = g.new_empty(cols, dtype=torch.float32)
    launch(kernel_bias_grad, _lib().srpde_token_bias_grad, g, ptr(g), rows, cols,
           int(g.dtype == torch.bfloat16), ptr(partial), MAX_BLOCKS, ptr(out), dtype=g.dtype)
    return out


def kernel_layer_norm_affine_grad(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                                  rstd: torch.Tensor):
    """One call (the kernel, then the sum of its partials): the weight and
    bias gradients, ``(C,)`` float32 each."""
    check_kernel_widths(g, x, mean, rstd)
    rows, cols = g.shape
    partial = g.new_empty(MAX_BLOCKS, 2 * cols, dtype=torch.float32)
    dweight = g.new_empty(cols, dtype=torch.float32)
    dbias = torch.empty_like(dweight)
    launch(kernel_layer_norm_affine_grad, _lib().srpde_token_layer_norm_affine_grad, g, ptr(g),
           ptr(x), ptr(mean), ptr(rstd), rows, cols, int(g.dtype == torch.bfloat16),
           ptr(partial), MAX_BLOCKS, ptr(dweight), ptr(dbias), dtype=g.dtype)
    return dweight, dbias


KERNELS = (kernel_bias_grad, kernel_layer_norm_affine_grad)
reset_launch_counts = functools.partial(_build.reset_launch_counts, KERNELS)
launch_counts = functools.partial(_build.launch_counts, KERNELS)


# The operators under which a profiler's trace finds the kernels' calls (the
# benchmark looks for ``swinir::token_``): defined on the dispatcher with a
# CUDA kernel alone, a few microseconds a call, where ``torch.library.custom_op``
# adds ~20 us of Python (218 calls a train step of a published-width SwinIR).
_LIBRARY = torch.library.Library("swinir", "FRAGMENT")
_LIBRARY.define("token_bias_grad(Tensor g) -> Tensor")
_LIBRARY.define("token_layer_norm_affine_grad(Tensor g, Tensor x, Tensor mean, Tensor rstd) "
                "-> (Tensor, Tensor)")
_LIBRARY.impl("token_bias_grad", kernel_bias_grad, "CUDA")
_LIBRARY.impl("token_layer_norm_affine_grad", kernel_layer_norm_affine_grad, "CUDA")
_bias_grad_op = torch.ops.swinir.token_bias_grad.default
_layer_norm_affine_grad_op = torch.ops.swinir.token_layer_norm_affine_grad.default


# ------------------------------------------------------------------ dispatch
def bias_grad(g: torch.Tensor) -> torch.Tensor:
    """``(M, C) -> (C,)``: the column sums of ``g`` (a linear's bias gradient)."""
    if g.device.type == "cpu":
        return plain_bias_grad(g)
    return _bias_grad_op(g)


def layer_norm_affine_grad(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                           rstd: torch.Tensor):
    """A LayerNorm's ``(weight, bias)`` gradients from its output gradient
    ``g`` and input ``x``, both ``(M, C)``, and its forward's ``mean`` and
    ``rstd``, ``(M,)``."""
    if g.device.type == "cpu":
        return plain_layer_norm_affine_grad(g, x, mean, rstd)
    return _layer_norm_affine_grad_op(g, x, mean, rstd)


# ---------------------------------------------------- the linear and LayerNorm
class _Linear(torch.autograd.Function):
    """``F.linear`` whose bias gradient is :func:`bias_grad`; the input and
    weight gradients are ``AddmmBackward0``'s two ``mm``."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.linear(x, weight, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dbias = bias_grad(g2.contiguous()) if ctx.needs_input_grad[2] else None
        dx = g2.mm(weight).view(x.shape) if ctx.needs_input_grad[0] else None
        dweight = g2.t().mm(x.reshape(-1, x.shape[-1])) if ctx.needs_input_grad[1] else None
        return dx, dweight, dbias


class _LayerNorm(torch.autograd.Function):
    """``F.layer_norm`` over the last dimension whose weight and bias
    gradients are :func:`layer_norm_affine_grad`; the input gradient is
    ``native_layer_norm_backward``'s, asked for that alone."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        out, mean, rstd = torch.native_layer_norm(x, weight.shape, weight, bias, eps)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        g, x = g.contiguous(), x.contiguous()
        dx = dweight = dbias = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            c = weight.numel()
            dweight, dbias = layer_norm_affine_grad(g.view(-1, c), x.view(-1, c), mean.view(-1),
                                                    rstd.view(-1))
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.native_layer_norm_backward(
                g, x, weight.shape, mean, rstd, weight, bias, [True, False, False])[0]
        return dx, dweight, dbias, None


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, weight, bias)``, its bias gradient from :func:`bias_grad`.
    Under autocast the arguments are cast as autocast casts them for
    ``F.linear``: floating tensors other than float64 to its dtype."""
    if not torch.is_grad_enabled():
        return F.linear(x, weight, bias)
    device = x.device.type
    if not torch.is_autocast_enabled(device):
        return _Linear.apply(x, weight, bias)
    dtype = torch.get_autocast_dtype(device)
    with torch.autocast(device, enabled=False):
        return _Linear.apply(*(t.to(dtype) if t.dtype != torch.float64 else t
                               for t in (x, weight, bias)))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """``F.layer_norm`` over the last dimension, its weight and bias gradients
    from :func:`layer_norm_affine_grad`. Under CUDA autocast the arguments are
    cast to float32, as autocast casts them for ``F.layer_norm`` there (the
    CPU's autocast leaves them as they come)."""
    if not torch.is_grad_enabled():
        return F.layer_norm(x, weight.shape, weight, bias, eps)
    if x.device.type != "cuda" or not torch.is_autocast_enabled("cuda"):
        return _LayerNorm.apply(x, weight, bias, eps)
    with torch.autocast("cuda", enabled=False):
        return _LayerNorm.apply(*(t.float() if t.dtype != torch.float64 else t
                                  for t in (x, weight, bias)), eps)
